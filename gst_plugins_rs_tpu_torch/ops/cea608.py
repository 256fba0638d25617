"""CEA-608 closed-caption byte-pair codec (line-21 captions).

From-scratch equivalent of the cea608-types crate the reference's
closedcaption plugin builds on (video/closedcaption/src/cea608utils.rs,
tttocea608/imp.rs, cea608tott/imp.rs).  Covers channel-1 field-1 captions:
odd parity, the standard character set, preamble address codes (PAC), and
the control codes needed for pop-on and roll-up modes.

Everything here is host control plane (captions are a few bytes per frame);
the device-side part of the family is the overlay compositor
(elements/cc/overlay.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# -- parity -----------------------------------------------------------------
def with_parity(b: int) -> int:
    """Set bit 7 so the byte has odd parity (CEA-608 §"parity")."""
    return b | (0x80 if bin(b & 0x7F).count("1") % 2 == 0 else 0)


def strip_parity(b: int) -> Optional[int]:
    """Remove the parity bit; None if parity is invalid (decoder drops pair)."""
    if bin(b).count("1") % 2 == 1:
        return b & 0x7F
    return None


# -- control codes (channel 1, field 1) ---------------------------------------
CTRL = 0x14
RCL = 0x20  # resume caption loading (pop-on)
BS = 0x21   # backspace
DER = 0x24  # delete to end of row
RU2 = 0x25  # roll-up 2 rows
RU3 = 0x26
RU4 = 0x27
RDC = 0x29  # resume direct captioning (paint-on)
TR = 0x2A   # text restart
EDM = 0x2C  # erase displayed memory
CR = 0x2D   # carriage return (roll-up scroll)
ENM = 0x2E  # erase non-displayed memory
EOC = 0x2F  # end of caption (swap pop-on buffers)

# PAC first/second base bytes per row 1..15 (CEA-608 Table 53, white/no
# indent/no underline)
_PAC_ROW = {
    1: (0x11, 0x40), 2: (0x11, 0x60), 3: (0x12, 0x40), 4: (0x12, 0x60),
    5: (0x15, 0x40), 6: (0x15, 0x60), 7: (0x16, 0x40), 8: (0x16, 0x60),
    9: (0x17, 0x40), 10: (0x17, 0x60), 11: (0x10, 0x40), 12: (0x13, 0x40),
    13: (0x13, 0x60), 14: (0x14, 0x40), 15: (0x14, 0x60),
}
_PAC_ROW_REV = {v: k for k, v in _PAC_ROW.items()}

# standard character set: ASCII with the CEA-608 substitutions
_CHAR_OVERRIDES = {
    0x2A: "á", 0x5C: "é", 0x5E: "í", 0x5F: "ó", 0x60: "ú",
    0x7B: "ç", 0x7C: "÷", 0x7D: "Ñ", 0x7E: "ñ", 0x7F: "█",
}
_CHAR_OVERRIDES_REV = {v: k for k, v in _CHAR_OVERRIDES.items()}


def char_to_byte(c: str) -> Optional[int]:
    if c in _CHAR_OVERRIDES_REV:
        return _CHAR_OVERRIDES_REV[c]
    b = ord(c)
    if 0x20 <= b < 0x80 and b not in _CHAR_OVERRIDES:
        return b
    return None


def byte_to_char(b: int) -> str:
    return _CHAR_OVERRIDES.get(b, chr(b))


def control_pair(cc2: int) -> Tuple[int, int]:
    return with_parity(CTRL), with_parity(cc2)


def pac_pair(row: int, indent: int = 0) -> Tuple[int, int]:
    """PAC for a row; indent (0..28, steps of 4) selects the indent PAC
    form (second byte 0x10-bit set, cursor at column `indent`, white)."""
    a, b = _PAC_ROW[row]
    if indent:
        b = b + 0x10 + (min(indent, 28) // 4) * 2
    return with_parity(a), with_parity(b)


def tab_offset_pair(cols: int) -> Tuple[int, int]:
    """Tab Offset 1..3: advances the cursor by `cols` columns after a PAC
    (CEA-608 §8.4; first byte 0x17 channel 1)."""
    return with_parity(0x17), with_parity(0x20 + max(1, min(3, cols)))


def encode_text_pairs(text: str) -> List[Tuple[int, int]]:
    """Characters packed two per pair, padded with 0x00 (no second char)."""
    bytes_ = [bb for c in text if (bb := char_to_byte(c)) is not None]
    pairs = []
    for i in range(0, len(bytes_), 2):
        hi = bytes_[i]
        lo = bytes_[i + 1] if i + 1 < len(bytes_) else 0
        pairs.append((with_parity(hi), with_parity(lo) if lo else 0x80))
    return pairs


def _position_pairs(row: int, column: int) -> List[Tuple[int, int]]:
    """Doubled PAC (+ optional Tab Offset) placing the cursor at
    (row, column): indent PACs move in steps of 4, TO1-3 the remainder."""
    indent = (column // 4) * 4
    out = [pac_pair(row, indent), pac_pair(row, indent)]
    if column % 4:
        out.append(tab_offset_pair(column % 4))
        out.append(tab_offset_pair(column % 4))
    return out


def encode_pop_on(lines: List[str], base_row: int = 14,
                  column: int = 0) -> List[Tuple[int, int]]:
    """Pop-on caption: RCL, ENM, per-line PAC+chars, EOC displays it
    (the sequence tttocea608 emits in PopOn mode, tttocea608/imp.rs:223-261).
    Control codes are doubled per the spec."""
    out = [control_pair(RCL), control_pair(RCL), control_pair(ENM), control_pair(ENM)]
    first_row = max(1, base_row - len(lines) + 1)
    for i, line in enumerate(lines):
        out.extend(_position_pairs(first_row + i, column))
        out.extend(encode_text_pairs(line))
    out.append(control_pair(EOC))
    out.append(control_pair(EOC))
    return out


def encode_roll_up(line: str, rows: int = 2, base_row: int = 14,
                   column: int = 0) -> List[Tuple[int, int]]:
    """One roll-up line: RUx, CR (scroll), PAC, chars (tttocea608 RollUp2
    default, tttocea608/imp.rs:25)."""
    ru = {2: RU2, 3: RU3, 4: RU4}[rows]
    out = [control_pair(ru), control_pair(ru), control_pair(CR), control_pair(CR)]
    out.extend(_position_pairs(base_row, column))
    out.extend(encode_text_pairs(line))
    return out


def erase_displayed() -> List[Tuple[int, int]]:
    return [control_pair(EDM), control_pair(EDM)]


PADDING = (0x80, 0x80)


@dataclass
class Caption:
    """A decoded displayed caption."""

    lines: List[str]
    mode: str  # "pop-on" | "roll-up" | "paint-on"


@dataclass
class Cea608Decoder:
    """Stateful channel-1 decoder: feed pairs, collect displayed captions.

    Mirrors the decode structure of cea608tott (cea608tott/imp.rs): pop-on
    text is accumulated in the non-displayed buffer and emitted at EOC;
    roll-up rows are emitted at CR; EDM yields an erase marker (None).
    """

    mode: str = "pop-on"
    rows: dict = field(default_factory=dict)  # row -> chars (building buffer)
    displayed: dict = field(default_factory=dict)
    current_row: int = 14
    _last_pair: Optional[Tuple[int, int]] = None
    events: List[Optional[Caption]] = field(default_factory=list)

    def _emit_rows(self, rows: dict, mode: str) -> None:
        lines = [rows[r].rstrip() for r in sorted(rows) if rows[r].strip()]
        if lines:
            self.events.append(Caption(lines, mode))

    def push_pair(self, hi: int, lo: int) -> None:
        if (hi, lo) == PADDING:
            self._last_pair = None
            return
        h = strip_parity(hi)
        l = strip_parity(lo)
        if h is None:
            return
        # doubled control codes: drop immediate duplicates
        if h < 0x20:
            if self._last_pair == (hi, lo):
                self._last_pair = None
                return
            self._last_pair = (hi, lo)
        else:
            self._last_pair = None

        if h >= 0x20:  # two basic characters
            self.rows.setdefault(self.current_row, "")
            self.rows[self.current_row] += byte_to_char(h)
            if l is not None and l >= 0x20:
                self.rows[self.current_row] += byte_to_char(l)
            return
        if l is None:
            return
        if (h, l) in _PAC_ROW_REV:
            self.current_row = _PAC_ROW_REV[(h, l)]
            self.rows.setdefault(self.current_row, "")
            return
        # indent PAC: same rows, second byte 0x10-bit + indent step bits
        for (a, b), row in _PAC_ROW_REV.items():
            if h == a and 0x10 <= int(l) - b <= 0x1E and (int(l) - b) % 2 == 0:
                self.current_row = row
                self.rows.setdefault(self.current_row, "")
                return
        if h == 0x17 and 0x21 <= l <= 0x23:
            return  # tab offset: cursor move only, no text effect here
        if h == CTRL:
            self._control(l)

    def _control(self, code: int) -> None:
        if code == RCL:
            self.mode = "pop-on"
            self.rows = {}
        elif code == ENM:
            self.rows = {}
        elif code == EOC:
            self.displayed = dict(self.rows)
            self._emit_rows(self.displayed, "pop-on")
            self.rows = {}
        elif code in (RU2, RU3, RU4):
            self.mode = "roll-up"
        elif code == CR:
            if self.mode == "roll-up":
                self._emit_rows(self.rows, "roll-up")
                self.rows = {}
        elif code == EDM:
            self.displayed = {}
            self.events.append(None)  # erase marker
        elif code == RDC:
            self.mode = "paint-on"
        elif code == BS:
            row = self.rows.get(self.current_row, "")
            self.rows[self.current_row] = row[:-1]

    def flush(self) -> None:
        """EOS: emit any pending roll-up text."""
        if self.mode == "roll-up" and self.rows:
            self._emit_rows(self.rows, "roll-up")
            self.rows = {}

    def take_events(self) -> List[Optional[Caption]]:
        ev, self.events = self.events, []
        return ev


__all__ = [
    "with_parity", "strip_parity", "control_pair", "pac_pair",
    "encode_text_pairs", "encode_pop_on", "encode_roll_up",
    "erase_displayed", "Cea608Decoder", "Caption", "PADDING",
    "RCL", "ENM", "EOC", "EDM", "CR", "RU2", "RU3", "RU4", "CTRL",
]
