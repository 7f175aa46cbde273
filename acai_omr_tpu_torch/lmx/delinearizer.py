"""LMX token stream -> MusicXML (score-partwise).

Rebuilt equivalent of the olimpic-icdar24 delinearizer the reference shells
out to (reference: acai_omr/inference/vitomr_inference.py:24-38,
ui/routes.py:8 ``Delinearizer.direct_delinearize``). Produces a pianoform
<score-partwise> with one part and (usually) two staves.

Error model matches the reference's reward plumbing
(acai_omr/train/omr_grpo_train.py:133-155): recoverable grammar violations
are *minor errors* (counted); an unbuildable stream raises
:class:`DelinearizationError` (the *catastrophic* case).

Musical semantics reconstructed beyond the tokens: integer ``divisions`` from
the LCM of all duration denominators, pitch ``<alter>`` from key signature +
in-measure printed accidentals, whole-measure rest durations from the active
time signature.
"""

from __future__ import annotations

import dataclasses
import math
import xml.etree.ElementTree as ET
from fractions import Fraction

from . import grammar as G


class DelinearizationError(Exception):
    """Catastrophic failure: the stream cannot be turned into MusicXML."""


@dataclasses.dataclass
class _Note:
    pitch: tuple[str, int] | str  # (step, octave) | "rest" | "rest:measure"
    grace: str | None = None      # None | "grace" | "grace:slash"
    chord: bool = False
    voice: str | None = None
    staff: str | None = None
    stem: str | None = None
    type_: str | None = None
    dots: int = 0
    accidental: str | None = None
    time_mod: tuple[int, int] | None = None
    beams: list = dataclasses.field(default_factory=list)
    ties: list = dataclasses.field(default_factory=list)
    tuplets: list = dataclasses.field(default_factory=list)
    slurs: list = dataclasses.field(default_factory=list)
    articulations: list = dataclasses.field(default_factory=list)
    ornaments: list = dataclasses.field(default_factory=list)
    notations: list = dataclasses.field(default_factory=list)
    print_object: bool = True

    def duration_quarters(self, measure_quarters: Fraction) -> Fraction | None:
        if self.grace:
            return None
        if self.pitch == "rest:measure":
            return measure_quarters
        base = G.TYPE_QUARTERS.get(self.type_ or "quarter", Fraction(1))
        dur = G.dotted(base, self.dots)
        if self.time_mod:
            actual, normal = self.time_mod
            dur = dur * Fraction(normal, actual)
        return dur


@dataclasses.dataclass
class _Move:  # backup / forward
    kind: str
    quarters: Fraction
    # last duration increment (the type token's value, then halved per dot):
    # "backup half dot" = 2 + 1 = 3 quarters, matching the linearizer's
    # greedy dot absorption (linearizer._decompose_move)
    last_add: Fraction = Fraction(0)


@dataclasses.dataclass
class _Attr:
    key_fifths: int | None = None
    time: tuple[int, int] | None = None
    clefs: list = dataclasses.field(default_factory=list)  # [(sign, line, staff)]

    def empty(self) -> bool:
        return self.key_fifths is None and self.time is None and not self.clefs


@dataclasses.dataclass
class _Measure:
    items: list = dataclasses.field(default_factory=list)


KEY_SHARPS = ["F", "C", "G", "D", "A", "E", "B"]


def _key_alters(fifths: int) -> dict[str, int]:
    if fifths > 0:
        return {s: 1 for s in KEY_SHARPS[:fifths]}
    if fifths < 0:
        return {s: -1 for s in KEY_SHARPS[::-1][:-fifths]}
    return {}


class Delinearizer:
    """Parse an LMX token string and build MusicXML."""

    def __init__(self):
        self.errors: list[str] = []

    # ------------------------------------------------------------------ parse

    def parse(self, lmx: str) -> list[_Measure]:
        tokens = lmx.strip().split()
        measures: list[_Measure] = []
        measure: _Measure | None = None
        note: _Note | None = None
        attr: _Attr | None = None
        move: _Move | None = None
        pending: dict = {"chord": False, "grace": None, "print_object": True}
        # current voice + per-voice stem/staff inheritance (matches the
        # linearizer's sticky-state model; see linearizer.py)
        sticky = {"voice": None, "per_voice": {}}
        last_clef_pending = False

        def vstate():
            return sticky["per_voice"].setdefault(
                sticky["voice"], {"stem": None, "staff": None})

        def minor(msg):
            self.errors.append(msg)

        def need_measure():
            nonlocal measure
            if measure is None:
                minor("content before first 'measure' token")
                start_measure()

        def start_measure():
            nonlocal measure, note, attr, move
            measure = _Measure()
            measures.append(measure)
            note = None
            attr = None
            move = None

        def get_attr() -> _Attr:
            nonlocal attr, note, move
            need_measure()
            note = None
            move = None
            if attr is None or measure.items[-1] is not attr:
                attr = _Attr()
                measure.items.append(attr)
            return attr

        i = 0
        expect_time = 0  # counts down beats/beat-type after a 'time' token
        time_parts: dict = {}
        while i < len(tokens):
            tok = tokens[i]
            i += 1

            if tok == "measure":
                start_measure()
                pending = {"chord": False, "grace": None, "print_object": True}
                continue

            # malformed structured tokens (unreachable from vocab-constrained
            # model output, reachable via the public delinearize()/CLI) are
            # MINOR errors, not uncaught ValueError/IndexError — the
            # documented contract is minor-recovery vs DelinearizationError
            # (round-5 review: a crash here escaped TEDn's catastrophic
            # catch and killed whole reward pools)
            if tok.startswith("key:fifths:"):
                try:
                    get_attr().key_fifths = int(tok.rsplit(":", 1)[1])
                except ValueError:
                    minor(f"malformed token '{tok}'")
                continue
            if tok == "time":
                get_attr()
                expect_time = 2
                time_parts = {}
                continue
            if tok.startswith("beats:"):
                try:
                    beats_val = int(tok.split(":")[1])
                except ValueError:
                    minor(f"malformed token '{tok}'")
                    continue
                if expect_time:
                    time_parts["beats"] = beats_val
                    expect_time -= 1
                else:
                    minor("beats token outside time signature")
                    time_parts = {"beats": beats_val}
                    expect_time = 1
                if "beats" in time_parts and "beat-type" in time_parts:
                    get_attr().time = (time_parts["beats"], time_parts["beat-type"])
                    # consume the pair: a stale 'beats' left here would
                    # combine with a later stray beat-type token into a
                    # fabricated time-signature change (round-5 review)
                    time_parts = {}
                continue
            if tok.startswith("beat-type:"):
                try:
                    bt_val = int(tok.split(":")[1])
                except ValueError:
                    minor(f"malformed token '{tok}'")
                    continue
                if expect_time:
                    time_parts["beat-type"] = bt_val
                    expect_time -= 1
                else:
                    minor("beat-type token outside time signature")
                    time_parts["beat-type"] = bt_val
                if "beats" in time_parts and "beat-type" in time_parts:
                    get_attr().time = (time_parts["beats"], time_parts["beat-type"])
                    time_parts = {}
                continue
            if tok.startswith("clef:"):
                sig = tok.split(":")[1]
                try:
                    sign, line = sig[0], int(sig[1:])
                except (ValueError, IndexError):
                    minor(f"malformed token '{tok}'")
                    continue
                a = get_attr()
                a.clefs.append([sign, line, None])
                last_clef_pending = True
                continue

            if tok in ("backup", "forward"):
                need_measure()
                note = None
                move = _Move(tok, Fraction(0))
                measure.items.append(move)
                continue

            if tok in ("chord",):
                pending["chord"] = True
                continue
            if tok in ("grace", "grace:slash"):
                pending["grace"] = tok
                continue
            if tok == "print-object:no":
                # always a prefix of the note it modifies (the linearizer
                # emits it before grace/chord/pitch — linearizer.py:102)
                pending["print_object"] = False
                continue

            if G.is_pitch(tok) or tok in ("rest", "rest:measure"):
                need_measure()
                move = None
                attr = None
                last_clef_pending = False
                pitch = (tok[0], int(tok[1])) if G.is_pitch(tok) else tok
                vs = vstate()
                note = _Note(
                    pitch=pitch, grace=pending["grace"], chord=pending["chord"],
                    voice=sticky["voice"], staff=vs["staff"],
                    stem=vs["stem"], print_object=pending["print_object"])
                measure.items.append(note)
                pending = {"chord": False, "grace": None, "print_object": True}
                continue

            if tok in G.TYPE_QUARTERS:
                if move is not None:
                    # each backup/forward token carries one type (+dots);
                    # accumulate if several duration tokens follow
                    move.quarters += G.TYPE_QUARTERS[tok]
                    move.last_add = G.TYPE_QUARTERS[tok]
                elif note is not None:
                    if note.type_ is None:
                        note.type_ = tok
                    else:
                        minor(f"duplicate duration type '{tok}'")
                else:
                    minor(f"duration type '{tok}' with no note context")
                continue
            if tok == "dot":
                if move is not None and move.last_add > 0:
                    move.last_add = move.last_add / 2  # dot halves per repeat
                    move.quarters += move.last_add
                elif note is not None:
                    note.dots += 1
                else:
                    minor("dot with no note context")
                continue

            if tok.startswith("voice:"):
                val = tok.split(":")[1]
                sticky["voice"] = val
                if note is not None:
                    note.voice = val
                    # the note was created under the previous voice; re-resolve
                    # its inherited stem/staff from the new voice's state
                    # (explicit stem:/staff: tokens follow voice: and override)
                    vs = vstate()
                    note.stem = vs["stem"]
                    note.staff = vs["staff"]
                continue
            if tok.startswith("staff:"):
                val = tok.split(":")[1]
                if last_clef_pending and attr is not None and attr.clefs:
                    attr.clefs[-1][2] = int(val)
                    last_clef_pending = False
                    continue
                if note is not None:
                    note.staff = val
                vstate()["staff"] = val
                continue
            if tok.startswith("stem:"):
                val = tok.split(":", 1)[1]
                if note is not None:
                    note.stem = val
                vstate()["stem"] = val
                continue

            if tok in G.ACCIDENTALS:
                if note is not None:
                    note.accidental = tok
                else:
                    minor(f"accidental '{tok}' with no note")
                continue
            if G.is_time_modification(tok):
                if note is not None:
                    note.time_mod = G.parse_time_modification(tok)
                else:
                    minor(f"time modification '{tok}' with no note")
                continue
            if tok in G.BEAM_VALUES:
                if note is not None:
                    note.beams.append(G.BEAM_VALUES[tok])
                else:
                    minor(f"beam token '{tok}' with no note")
                continue
            if tok.startswith("tied:"):
                if note is not None:
                    note.ties.append(tok.split(":")[1])
                else:
                    minor("tied token with no note")
                continue
            if tok.startswith("tuplet:"):
                if note is not None:
                    note.tuplets.append(tok.split(":")[1])
                else:
                    minor("tuplet token with no note")
                continue
            if tok.startswith("slur:"):
                if note is not None:
                    note.slurs.append(tok.split(":")[1])
                else:
                    minor("slur token with no note")
                continue
            if tok in G.ARTICULATIONS:
                if note is not None:
                    note.articulations.append(tok)
                else:
                    minor(f"articulation '{tok}' with no note")
                continue
            if tok in G.ORNAMENT_TOKENS:
                if note is not None:
                    note.ornaments.append(tok)
                else:
                    minor(f"ornament '{tok}' with no note")
                continue
            if tok in G.NOTATION_SINGLETONS:
                if note is not None:
                    note.notations.append(tok)
                else:
                    minor(f"notation '{tok}' with no note")
                continue

            minor(f"unknown token '{tok}'")

        return measures

    # ------------------------------------------------------------------ build

    def build(self, measures: list[_Measure]) -> ET.Element:
        if not measures:
            raise DelinearizationError("no measures parsed")

        # pass 1: durations in quarters, global divisions
        time_sig = (4, 4)
        denominators = {1}
        for m in measures:
            for item in m.items:
                if isinstance(item, _Attr) and item.time:
                    time_sig = item.time
                elif isinstance(item, _Note):
                    mq = Fraction(time_sig[0] * 4, time_sig[1])
                    d = item.duration_quarters(mq)
                    if d is not None:
                        denominators.add(d.denominator)
                elif isinstance(item, _Move):
                    denominators.add(item.quarters.denominator)
        divisions = math.lcm(*denominators)

        root = ET.Element("score-partwise", version="4.0")
        part_list = ET.SubElement(root, "part-list")
        sp = ET.SubElement(part_list, "score-part", id="P1")
        ET.SubElement(sp, "part-name").text = ""
        part = ET.SubElement(root, "part", id="P1")

        max_staff = 1
        for m in measures:
            for item in m.items:
                if isinstance(item, _Note) and item.staff:
                    max_staff = max(max_staff, int(item.staff))
                if isinstance(item, _Attr):
                    for c in item.clefs:
                        if c[2]:
                            max_staff = max(max_staff, c[2])

        time_sig = (4, 4)
        key_fifths = 0
        for mi, m in enumerate(measures):
            xm = ET.SubElement(part, "measure", number=str(mi + 1))
            accidental_state: dict = {}
            div_declared = mi != 0
            if mi == 0 and not (m.items
                                and isinstance(m.items[0], _Attr)):
                # a first measure whose stream opens with notes (no leading
                # key/time/clef tokens) must still declare divisions (and
                # staves): MusicXML consumers default divisions=1 and read
                # every duration wrong otherwise (round-4 review). When the
                # first item IS an _Attr, divisions ride its attributes
                # element as before (one element, the round-trip shape).
                xa0 = ET.SubElement(xm, "attributes")
                ET.SubElement(xa0, "divisions").text = str(divisions)
                if max_staff > 1:
                    ET.SubElement(xa0, "staves").text = str(max_staff)
                div_declared = True
            for item in m.items:
                if isinstance(item, _Attr):
                    if item.time:
                        time_sig = item.time
                    if item.key_fifths is not None:
                        key_fifths = item.key_fifths
                    xa = ET.SubElement(xm, "attributes")
                    if not div_declared:
                        ET.SubElement(xa, "divisions").text = str(divisions)
                        div_declared = True
                    if item.key_fifths is not None:
                        xk = ET.SubElement(xa, "key")
                        ET.SubElement(xk, "fifths").text = str(item.key_fifths)
                    if item.time:
                        xt = ET.SubElement(xa, "time")
                        ET.SubElement(xt, "beats").text = str(item.time[0])
                        ET.SubElement(xt, "beat-type").text = str(item.time[1])
                    if mi == 0 and max_staff > 1 and xa.find("divisions") \
                            is not None:
                        ET.SubElement(xa, "staves").text = str(max_staff)
                    for sign, line, staff in item.clefs:
                        xc = ET.SubElement(xa, "clef")
                        if staff:
                            xc.set("number", str(staff))
                        ET.SubElement(xc, "sign").text = sign
                        ET.SubElement(xc, "line").text = str(line)
                elif isinstance(item, _Move):
                    xmv = ET.SubElement(xm, item.kind)
                    dur = int(item.quarters * divisions)
                    ET.SubElement(xmv, "duration").text = str(max(dur, 1))
                elif isinstance(item, _Note):
                    self._build_note(xm, item, time_sig, key_fifths,
                                     accidental_state, divisions)
        return root

    def _build_note(self, xm, note: _Note, time_sig, key_fifths,
                    accidental_state, divisions):
        xn = ET.SubElement(xm, "note")
        if not note.print_object:
            xn.set("print-object", "no")
        if note.grace:
            g = ET.SubElement(xn, "grace")
            if note.grace == "grace:slash":
                g.set("slash", "yes")
        if note.chord:
            ET.SubElement(xn, "chord")

        if note.pitch in ("rest", "rest:measure"):
            xr = ET.SubElement(xn, "rest")
            if note.pitch == "rest:measure":
                xr.set("measure", "yes")
        else:
            step, octave = note.pitch
            xp = ET.SubElement(xn, "pitch")
            ET.SubElement(xp, "step").text = step
            alter = self._resolve_alter(note, step, octave, key_fifths,
                                        accidental_state)
            if alter is not None and alter != 0:
                ET.SubElement(xp, "alter").text = str(alter)
            ET.SubElement(xp, "octave").text = str(octave)

        mq = Fraction(time_sig[0] * 4, time_sig[1])
        dur = note.duration_quarters(mq)
        if dur is not None:
            ET.SubElement(xn, "duration").text = str(max(int(dur * divisions), 1))
        for t in note.ties:
            ET.SubElement(xn, "tie", type=t)
        if note.voice:
            ET.SubElement(xn, "voice").text = note.voice
        if note.type_ and note.pitch != "rest:measure":
            ET.SubElement(xn, "type").text = note.type_
        for _ in range(note.dots):
            ET.SubElement(xn, "dot")
        if note.accidental:
            ET.SubElement(xn, "accidental").text = note.accidental
        if note.time_mod:
            xtm = ET.SubElement(xn, "time-modification")
            ET.SubElement(xtm, "actual-notes").text = str(note.time_mod[0])
            ET.SubElement(xtm, "normal-notes").text = str(note.time_mod[1])
        if note.stem and note.pitch not in ("rest", "rest:measure"):
            ET.SubElement(xn, "stem").text = note.stem
        if note.staff:
            ET.SubElement(xn, "staff").text = note.staff
        for n, beam in enumerate(note.beams, start=1):
            ET.SubElement(xn, "beam", number=str(n)).text = beam

        if (note.ties or note.tuplets or note.slurs or note.articulations
                or note.ornaments or note.notations):
            xnot = ET.SubElement(xn, "notations")
            for t in note.ties:
                ET.SubElement(xnot, "tied", type=t)
            for s in note.slurs:
                ET.SubElement(xnot, "slur", type=s, number="1")
            for t in note.tuplets:
                ET.SubElement(xnot, "tuplet", type=t)
            if "fermata" in note.notations:
                ET.SubElement(xnot, "fermata")
            if "arpeggiate" in note.notations:
                ET.SubElement(xnot, "arpeggiate")
            if note.articulations:
                xart = ET.SubElement(xnot, "articulations")
                for a in note.articulations:
                    ET.SubElement(xart, a)
            if note.ornaments:
                xorn = ET.SubElement(xnot, "ornaments")
                for o in note.ornaments:
                    if o == "trill-mark":
                        ET.SubElement(xorn, "trill-mark")
                    elif o.startswith("tremolo"):
                        # one <tremolo type=T>N</tremolo> linearizes to the
                        # token PAIR "tremolo:T tremolo:N" (linearizer.py:181)
                        # — a numeric token folds into the preceding typed
                        # element rather than opening a duplicate (round-4
                        # review: the split elements charged ~2 TEDn edits
                        # per tremolo on token-perfect predictions)
                        val = o.split(":")[1]
                        if val in ("single", "start", "stop", "unmeasured"):
                            ET.SubElement(xorn, "tremolo", type=val)
                        else:
                            prev = xorn.findall("tremolo")
                            if prev and not (prev[-1].text or "").strip():
                                prev[-1].text = val
                            else:
                                ET.SubElement(xorn, "tremolo").text = val
        return xn

    def _resolve_alter(self, note: _Note, step, octave, key_fifths,
                       accidental_state):
        """<alter> from printed accidental, else in-measure accidental state,
        else key signature.

        Accidental state is keyed per STAFF: in a grand staff, a printed
        accidental on one staff does not alter the same pitch on the other
        (round-5 review — the staff-less key contaminated cross-staff
        pitches, charging TEDn edits against token-perfect rollouts)."""
        key = (note.staff, step, octave)
        if note.accidental:
            alter = G.accidental_to_alter(note.accidental)
            accidental_state[key] = alter
            return alter
        if key in accidental_state:
            return accidental_state[key]
        return _key_alters(key_fifths).get(step)


def delinearize_to_element(lmx: str) -> tuple[ET.Element, list[str]]:
    """LMX string -> (MusicXML root element, minor-error list).

    Raises DelinearizationError on catastrophic failure.
    """
    d = Delinearizer()
    measures = d.parse(lmx)
    root = d.build(measures)
    return root, d.errors


def delinearize(lmx: str) -> tuple[str, list[str]]:
    """LMX string -> (MusicXML document string, minor errors)."""
    root, errors = delinearize_to_element(lmx)
    ET.indent(root)
    body = ET.tostring(root, encoding="unicode")
    header = ('<?xml version="1.0" encoding="UTF-8"?>\n'
              '<!DOCTYPE score-partwise PUBLIC "-//Recordare//DTD MusicXML 4.0 '
              'Partwise//EN" "http://www.musicxml.org/dtds/partwise.dtd">\n')
    return header + body, errors
