"""MusicXML -> LMX token linearization (the twin of the JAX package's
``lmx/linearizer.py``, on the port's own :mod:`.grammar`).

The inverse of :mod:`.delinearizer`. Emission order of a note: [grace]
[chord] pitch, voice (on change), type, dot*, accidental, time-mod, stem (on
change), staff (on change), beam*, tied, tuplet, slur, articulations and
ornaments. Backup / forward durations are decomposed greedily into
single-type chunks, each re-emitting the ``backup`` / ``forward`` token
("backup half backup quarter").
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from fractions import Fraction

from . import grammar as G

_BEAM_TOKENS = {v: k for k, v in G.BEAM_VALUES.items()}

# types largest-first for greedy move decomposition
_TYPES_DESC = sorted(G.TYPE_QUARTERS.items(), key=lambda kv: -kv[1])


def _decompose_move(quarters: Fraction) -> list[list[str]]:
    """Duration -> chunks of [type, dot*] tokens, greedy largest-first."""
    chunks = []
    rem = quarters
    guard = 0
    while rem > 0 and guard < 64:
        guard += 1
        for name, q in _TYPES_DESC:
            if q <= rem:
                # try to absorb dots
                dots = 0
                total = q
                add = q
                while dots < 2 and total + add / 2 <= rem:
                    add = add / 2
                    total += add
                    dots += 1
                chunks.append([name] + ["dot"] * dots)
                rem -= total
                break
        else:
            break  # remainder smaller than the smallest type; drop it
    return chunks


def linearize_element(root: ET.Element) -> str:
    """<score-partwise> element -> LMX token string (first part only)."""
    part = root.find("part")
    if part is None:
        raise ValueError("no <part> element")

    tokens: list[str] = []
    divisions = 1

    for measure in part.findall("measure"):
        tokens.append("measure")
        # Sticky-state model matching the reference sequences: the current
        # voice resets per measure, and stem/staff are tracked *per voice*
        # (each voice's first note in a measure re-emits its stem/staff even
        # if another voice just used the same values).
        sticky = {"voice": None, "per_voice": {}}
        for el in measure:
            if el.tag == "attributes":
                d = el.find("divisions")
                if d is not None:
                    divisions = int(d.text)
                k = el.find("key/fifths")
                if k is not None:
                    tokens.append(f"key:fifths:{int(k.text)}")
                t = el.find("time")
                if t is not None and t.find("beats") is not None \
                        and t.find("beat-type") is not None:
                    # schema-valid <time><senza-misura/></time> has neither
                    # child; emit no time tokens rather than crash. Compound
                    # signatures ('3+2' beats) have no vocab token — skip
                    # the time tokens rather than crash target production
                    try:
                        beats = int(t.find("beats").text)
                        beat_type = int(t.find("beat-type").text)
                    except (TypeError, ValueError):
                        beats = None
                    if beats is not None:
                        tokens.append("time")
                        tokens.append(f"beats:{beats}")
                        tokens.append(f"beat-type:{beat_type}")
                for clef in el.findall("clef"):
                    sign = clef.find("sign").text
                    if sign not in ("G", "F", "C"):
                        # percussion/TAB/none clefs have no vocab token —
                        # skip like other out-of-vocab elements instead of
                        # KeyError-crashing linearize()
                        continue
                    line = clef.find("line")
                    line = line.text if line is not None else {"G": "2", "F": "4", "C": "3"}[sign]
                    tokens.append(f"clef:{sign}{line}")
                    num = clef.get("number")
                    if num:
                        tokens.append(f"staff:{num}")
            elif el.tag in ("backup", "forward"):
                dur = int(el.find("duration").text)
                for chunk in _decompose_move(Fraction(dur, divisions)):
                    tokens.append(el.tag)
                    tokens.extend(chunk)
            elif el.tag == "note":
                tokens.extend(_note_tokens(el, sticky))
    return " ".join(tokens)


def _note_tokens(el: ET.Element, sticky: dict) -> list[str]:
    out: list[str] = []
    if el.get("print-object") == "no":
        out.append("print-object:no")
    grace = el.find("grace")
    if grace is not None:
        out.append("grace:slash" if grace.get("slash") == "yes" else "grace")
    if el.find("chord") is not None:
        out.append("chord")

    rest = el.find("rest")
    if rest is not None:
        out.append("rest:measure" if rest.get("measure") == "yes" else "rest")
    else:
        pitch = el.find("pitch")
        if pitch is None:
            return []  # unpitched elements are out of vocabulary
        out.append(f"{pitch.find('step').text}{int(pitch.find('octave').text)}")

    voice = el.find("voice")
    if voice is not None and voice.text != sticky["voice"]:
        sticky["voice"] = voice.text
        out.append(f"voice:{voice.text}")
    vstate = sticky["per_voice"].setdefault(sticky["voice"], {"stem": None, "staff": None})

    typ = el.find("type")
    if typ is not None:
        out.append(typ.text)
    out.extend(["dot"] * len(el.findall("dot")))

    acc = el.find("accidental")
    if acc is not None and acc.text in G.ACCIDENTALS:
        out.append(acc.text)

    tm = el.find("time-modification")
    if tm is not None:
        actual = int(tm.find("actual-notes").text)
        normal = int(tm.find("normal-notes").text)
        out.append(f"{actual}in{normal}")

    stem = el.find("stem")
    if stem is not None and stem.text != vstate["stem"]:
        vstate["stem"] = stem.text
        out.append(f"stem:{stem.text}")
    staff = el.find("staff")
    if staff is not None and staff.text != vstate["staff"]:
        vstate["staff"] = staff.text
        out.append(f"staff:{staff.text}")

    for beam in el.findall("beam"):
        tok = _BEAM_TOKENS.get(beam.text)
        if tok:
            out.append(tok)

    notations = el.find("notations")
    # DOCUMENT order, not canonical (start, stop): mid-tie notes carry
    # stop-then-start (the MusicXML convention for tie chains), and the
    # delinearizer rebuilds <tie>/<tied> in token order — canonicalizing
    # here charged 4 TEDn edits per mid-tie note on token-perfect output
    tied_order: list[str] = []
    for t in el.findall("tie"):
        ty = t.get("type")
        if ty in ("start", "stop") and ty not in tied_order:
            tied_order.append(ty)
    if notations is not None:
        for t in notations.findall("tied"):
            ty = t.get("type")
            if ty in ("start", "stop") and ty not in tied_order:
                tied_order.append(ty)
    for ty in tied_order:
        out.append(f"tied:{ty}")
    if notations is not None:
        for tup in notations.findall("tuplet"):
            out.append(f"tuplet:{tup.get('type')}")
        for slur in notations.findall("slur"):
            if slur.get("type") in ("start", "stop"):
                out.append(f"slur:{slur.get('type')}")
        if notations.find("fermata") is not None:
            out.append("fermata")
        if notations.find("arpeggiate") is not None:
            out.append("arpeggiate")
        art = notations.find("articulations")
        if art is not None:
            for a in art:
                if a.tag in G.ARTICULATIONS:
                    out.append(a.tag)
        orn = notations.find("ornaments")
        if orn is not None:
            for o in orn:
                if o.tag == "trill-mark":
                    out.append("trill-mark")
                elif o.tag == "tremolo":
                    t = o.get("type")
                    if t in ("single", "start", "stop", "unmeasured"):
                        out.append(f"tremolo:{t}")
                    if (o.text or "").strip() in ("1", "2", "3", "4"):
                        out.append(f"tremolo:{o.text.strip()}")
    return out


def linearize(musicxml: str) -> str:
    """MusicXML document string -> LMX token string."""
    return linearize_element(ET.fromstring(musicxml))
