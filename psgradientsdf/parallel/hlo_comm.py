"""Communication accounting from compiled HLO (SURVEY §5.7-5.8).

Parses the post-GSPMD HLO of a compiled executable and totals the bytes
moved by every collective (all-reduce, all-gather, reduce-scatter,
collective-permute, all-to-all).  The claim "the scan's per-frame communication is O(KB), so Z-slab sharding
scales" is checked directly from the compiled program rather than
asserted — tests/test_scaling_model.py pins it.

Byte counts are per-device operand bytes of each collective instruction
(the data a device contributes/receives once), not link-level traffic —
a mesh-topology-independent lower bound that is exact for psum-style
all-reduces of replicated results, which is every collective the scan
emits.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "collective-permute",
    "all-to-all",
)

# one shape token: dtype[dims]
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_tok: str) -> int:
    m = _SHAPE_RE.match(shape_tok)
    if not m:
        return 0
    dtype, dims = m.group(1), m.group(2)
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def collective_ops(hlo_text: str) -> List[Tuple[str, str, int]]:
    """[(op_kind, result_shape_text, bytes)] for every collective
    instruction in the HLO text.  Tuple-shaped results count the sum of
    their leaves.  `*-start` / `*-done` async pairs are counted once (on
    the -start; the -done re-states the same shape)."""
    out = []
    for line in hlo_text.splitlines():
        s = line.strip()
        eq = s.find(" = ")
        if eq < 0:
            continue
        rhs = s[eq + 3:]
        # result shape(s) appear between '=' and the op name; layout
        # annotations like {1,0} or {0,1:T(8,128)} may follow each shape
        for kind in _COLLECTIVES:
            m = re.search(r"(?:^|\s)" + kind + r"(-start)?\(", rhs)
            if m is None:
                continue
            shape_txt = rhs[:m.start()]
            # drop layout annotations so they are not parsed as shapes
            shape_txt = re.sub(r"\{[^}]*\}", "", shape_txt)
            total = sum(_shape_bytes(tok.group(0))
                        for tok in _SHAPE_RE.finditer(shape_txt))
            out.append((kind, shape_txt.strip(), total))
            break
    return out


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Total bytes per collective kind + 'total'."""
    totals: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for kind, _, b in collective_ops(hlo_text):
        totals[kind] += b
    totals["total"] = sum(totals[k] for k in _COLLECTIVES)
    return totals
