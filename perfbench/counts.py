"""The yardstick's arithmetic of work: the table of peaks, a sparse
conv's operations and bytes, and the least time a set of convs could
take on the card. A family's ``building_work`` (families/<family>.py)
counts one building's work from the problem (the voxel coordinates, the
channel widths and the dtypes), so that it reads the same whatever
implements it, and gives its sparse convs as :class:`Conv`.

A sparse conv's operations are 2 * pairs * Cin * Cout, its pairs the
real (input row, output row) entries of its rulebook. Bytes count each
input and output byte of a call once: the valid input and output rows,
the weights and the rulebook's columns of the valid output rows.

A masked BN site (:func:`bn_bytes`) and a rotated ROI pooler call
(:func:`roi_bytes`) are bound by their bytes alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

# NVIDIA's data sheet, H100 SXM, dense: bf16 / fp16 and float32 outside
# the tensor cores in FLOP/s, HBM3 in bytes/s (at the 700 W limit)
PEAKS = {"NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "float16": 989e12,
                                   "float32": 67e12, "hbm": 3.35e12}}


def peaks(device_name: str):
    """The peaks of the card named ``device_name``, or None when the
    table has no such card."""
    return PEAKS.get(device_name)


@dataclass
class Conv:
    """One sparse conv of the forward, as kernel A runs it."""
    name: str
    k: int          # rulebook offsets
    pairs: int
    rows_in: int
    rows_out: int
    cin: int
    cout: int

    @property
    def flops(self) -> float:
        return 2.0 * self.pairs * self.cin * self.cout

    def bytes(self, esize: int) -> float:
        return (esize * (self.rows_in * self.cin + self.rows_out * self.cout
                         + self.k * self.cin * self.cout)
                + 4 * self.k * self.rows_out)


def least_seconds(convs: List[Conv], esize: int, peak: Dict,
                  dtype: str) -> float:
    """The least time the card could take for ``convs``, each bound by
    the larger of its operations over the peak rate and its bytes over
    the memory bandwidth."""
    return sum(max(c.flops / peak[dtype], c.bytes(esize) / peak["hbm"])
               for c in convs)


def backward_least_seconds(convs: List[Conv], esize: int, peak: Dict,
                           dtype: str) -> float:
    """The same for the backward of ``convs`` (kernel A'): dFeats of every
    conv but the first, whose input takes no gradient (the output's
    gradient, the weights and the transposed book in, the input's
    gradient out), and dW of every conv (the input, the output's
    gradient and the book in, float32 weights' gradient out)."""
    total = 0.0
    for i, c in enumerate(convs):
        rows = esize * (c.rows_in * c.cin + c.rows_out * c.cout)
        book = 4 * c.k * c.rows_out
        dw = rows + book + 4 * c.k * c.cin * c.cout
        total += max(c.flops / peak[dtype], dw / peak["hbm"])
        if i > 0:
            dfeats = rows + book + esize * c.k * c.cin * c.cout
            total += max(c.flops / peak[dtype], dfeats / peak["hbm"])
    return total


# the passes over a masked BN site's valid rows that move its least
# bytes: the forward reads x and writes y; a training step's backward
# also reads x and the output's gradient and writes the input's
BN_PASSES = {False: 2, True: 5}


def bn_site(rows: int, c: int, train: bool) -> Dict:
    """One masked BN site (and its activation) over ``rows`` valid rows of
    ``c`` channels, of a forward or (``train``) a training step."""
    return {"rows": int(rows), "c": int(c), "passes": BN_PASSES[train]}


def bn_bytes(sites: List[Dict], esize: int) -> float:
    """The least bytes of masked BN ``sites`` (:func:`bn_site`): each
    pass moves its valid rows once, ``esize`` bytes an element."""
    return float(sum(s["passes"] * esize * s["rows"] * s["c"]
                     for s in sites))


def roi_pool(rois: int, bins: int, c: int, rows: int) -> Dict:
    """One call of the rotated ROI pooler: ``rois`` rois of ``bins`` bins
    each from a merged table of ``rows`` rows (the pooled levels' valid
    rows) and ``c`` channels."""
    return {"rois": int(rois), "bins": int(bins), "c": int(c),
            "rows": int(rows)}


def roi_bytes(pools: List[Dict], esize: int) -> float:
    """The least bytes of pooler calls (:func:`roi_pool`): each writes its
    pooled output and reads the merged table's features, its int64 keys
    and its rois (7 float32 numbers each) once."""
    return float(sum(p["rois"] * p["bins"] * p["c"] * esize
                     + p["rows"] * (p["c"] * esize + 8) + 28 * p["rois"]
                     for p in pools))
