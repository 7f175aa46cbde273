"""LMX (Linearized MusicXML) token grammar.

The reference depends on the olimpic-icdar24 submodule for
linearization/delinearization (reference: .gitmodules:1-3,
vitomr_inference.py:24-29) which is not vendored in the snapshot; this package
rebuilds the LMX grammar from the 227-token vocabulary (lmx_vocab.txt) and the
sequence structure observable in the reference's sampled predictions
(misc/sampled_predictions/vitomr_predictions/*/target_seq.txt):

* ``measure`` opens each measure; attribute tokens follow
  (``key:fifths:N``, ``time beats:N beat-type:N``, ``clef:XX [staff:N]``).
* A note = [``grace[:slash]``] [``chord``] pitch|``rest``|``rest:measure``
  then modifiers: ``voice:N`` (sticky), duration type, ``dot``*, accidental,
  time-modification ``NinM``, ``stem:*`` (sticky), ``staff:N`` (sticky),
  ``beam:*``*, ``tied:*``, ``tuplet:*``, ``slur:*``, articulations/ornaments.
* ``backup`` / ``forward`` each carry their duration as type (+``dot``)
  tokens; long moves appear as consecutive backup elements
  ("backup half backup quarter" = 3 quarters).
"""

from __future__ import annotations

from fractions import Fraction

PITCH_STEPS = "ABCDEFG"

# duration type -> length in quarter notes
TYPE_QUARTERS = {
    "1024th": Fraction(1, 256), "512th": Fraction(1, 128),
    "256th": Fraction(1, 64), "128th": Fraction(1, 32),
    "64th": Fraction(1, 16), "32nd": Fraction(1, 8),
    "16th": Fraction(1, 4), "eighth": Fraction(1, 2),
    "quarter": Fraction(1), "half": Fraction(2), "whole": Fraction(4),
    "breve": Fraction(8), "long": Fraction(16), "maxima": Fraction(32),
}

ACCIDENTALS = {"sharp", "flat", "natural", "double-sharp", "flat-flat",
               "natural-sharp", "natural-flat"}

ARTICULATIONS = {"staccato", "accent", "strong-accent", "tenuto"}
ORNAMENT_TOKENS = {"trill-mark", "tremolo:single", "tremolo:start",
                   "tremolo:stop", "tremolo:unmeasured",
                   "tremolo:1", "tremolo:2", "tremolo:3", "tremolo:4"}
NOTATION_SINGLETONS = {"fermata", "arpeggiate"}

BEAM_VALUES = {"beam:begin": "begin", "beam:end": "end",
               "beam:forward-hook": "forward hook",
               "beam:backward-hook": "backward hook"}


def is_pitch(tok: str) -> bool:
    return (len(tok) == 2 and tok[0] in PITCH_STEPS and tok[1].isdigit())


def is_time_modification(tok: str) -> bool:
    if "in" not in tok:
        return False
    a, _, b = tok.partition("in")
    return a.isdigit() and b.isdigit()


def parse_time_modification(tok: str) -> tuple[int, int]:
    """'3in2' -> (actual=3, normal=2): 3 notes in the time of 2."""
    a, _, b = tok.partition("in")
    return int(a), int(b)


def accidental_to_alter(acc: str) -> int | None:
    """Printed accidental -> pitch <alter> value (None = no alter element)."""
    return {
        "sharp": 1, "flat": -1, "natural": None, "double-sharp": 2,
        "flat-flat": -2, "natural-sharp": 1, "natural-flat": -1,
    }.get(acc)


def dotted(base: Fraction, dots: int) -> Fraction:
    out = base
    add = base
    for _ in range(dots):
        add = add / 2
        out = out + add
    return out
