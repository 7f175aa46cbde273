"""CLI: linearize / delinearize LMX <-> MusicXML files (the twin of the JAX
package's ``lmx/__main__.py``).

    python -m acai_omr_tpu_torch.lmx delinearize score.lmx score.musicxml
    python -m acai_omr_tpu_torch.lmx linearize score.musicxml score.lmx

Delinearization problems print to stderr (non-empty stderr = minor
problems, a non-zero exit = a catastrophic failure).
"""

import sys
from pathlib import Path


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 3 or argv[0] not in ("linearize", "delinearize"):
        print(__doc__, file=sys.stderr)
        raise SystemExit(2)
    mode, src, dst = argv
    text = Path(src).read_text()
    if mode == "delinearize":
        from .delinearizer import DelinearizationError, delinearize
        try:
            xml, problems = delinearize(text)
        except DelinearizationError as e:
            print(f"delinearization failed: {e}", file=sys.stderr)
            raise SystemExit(1)
        Path(dst).write_text(xml)
        for p in problems:
            print(p, file=sys.stderr)
    else:
        from .linearizer import linearize
        Path(dst).write_text(linearize(text) + "\n")


if __name__ == "__main__":
    main()
