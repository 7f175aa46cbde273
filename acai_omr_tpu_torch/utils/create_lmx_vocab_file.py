"""Regenerate ``lmx_vocab.txt`` from the LMX grammar (the twin of the JAX
package's ``utils/create_lmx_vocab_file.py``).

``<bos>`` / ``<pad>`` / ``<eos>`` first, then the LMX vocabulary in the
canonical order that reproduces the repository's 227-line file byte for
byte. Run: ``python -m acai_omr_tpu_torch.utils.create_lmx_vocab_file
[PATH]``.
"""

from __future__ import annotations

PITCH_STEPS = "CDEFGAB"

TUPLET_RATIOS = [
    "3in2", "6in4", "2in1", "2in3", "5in4", "7in8", "7in6", "9in8", "4in3",
    "7in4", "4in6", "13in8", "22in16", "10in4", "12in8", "9in4", "10in8",
    "18in4", "16in8", "15in8", "5in3", "11in8", "11in12", "5in2", "8in2",
    "4in2", "7in1", "35in16", "9in2",
]


def vocabulary() -> list[str]:
    toks = ["<bos>", "<pad>", "<eos>"]
    toks.append("measure")
    toks += [f"key:fifths:{i}" for i in range(-7, 8)]
    toks.append("time")
    toks += [f"beats:{i}" for i in range(1, 17)]
    toks += [f"beat-type:{i}" for i in (2, 4, 8, 16)]
    toks += [f"clef:{s}{l}" for s in "GCF" for l in range(1, 6)]
    toks.append("print-object:no")
    toks += ["grace", "grace:slash", "chord"]
    toks += [f"{step}{octave}" for octave in range(10) for step in PITCH_STEPS]
    toks += ["rest", "forward", "backup"]
    toks += [f"voice:{i}" for i in range(1, 13)]
    toks += ["1024th", "512th", "256th", "128th", "64th", "32nd", "16th",
             "eighth", "quarter", "half", "whole", "breve", "long", "maxima"]
    toks.append("rest:measure")
    toks += TUPLET_RATIOS
    toks.append("dot")
    toks += ["sharp", "flat", "natural", "double-sharp", "flat-flat",
             "natural-sharp", "natural-flat"]
    toks += ["stem:up", "stem:down", "stem:none"]
    toks += [f"staff:{i}" for i in range(1, 4)]
    toks += ["beam:begin", "beam:end", "beam:forward-hook", "beam:backward-hook"]
    toks += ["tied:start", "tied:stop", "tuplet:start", "tuplet:stop",
             "slur:start", "slur:stop"]
    toks += ["fermata", "arpeggiate", "staccato", "accent", "strong-accent",
             "tenuto", "trill-mark"]
    toks += ["tremolo:single", "tremolo:start", "tremolo:stop",
             "tremolo:unmeasured", "tremolo:1", "tremolo:2", "tremolo:3",
             "tremolo:4"]
    return toks


def main(path: str = "lmx_vocab.txt"):
    """Write the vocabulary to ``path``, one token a line."""
    toks = vocabulary()
    with open(path, "w") as f:
        f.write("\n".join(toks) + "\n")
    print(f"Wrote {len(toks)} tokens to {path}")


if __name__ == "__main__":
    import sys
    main(*sys.argv[1:2])
