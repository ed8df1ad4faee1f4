"""Kernel B's least time for the traced sub-window's buildings over its
device time there, %: the least time of each book the family counts
(``b_books`` of its building_work: a book's offsets and its level's
voxels) is its bytes over the memory bandwidth, the bytes of each valid
row (as counts.py counts valid rows) its int32 entries, its int64 row
mask words, its key and its int32 coordinates. None where the family
counts no books or B ran for no time."""


def book_bytes(book) -> float:
    words = 1 if book["k"] <= 64 else 2
    return book["rows"] * (4 * book["k"] + 8 * words + 8 + 16)


def read(run):
    s = run.sub
    if s is None or run.peaks is None or not s["kernel_s"].get("B"):
        return None
    books = [bk for b in run.window["sub_buildings"]
             for bk in run.work[b].get("b_books", ())]
    if not books:
        return None
    least = sum(book_bytes(bk) for bk in books) / run.peaks["hbm"]
    return 100.0 * least / s["kernel_s"]["B"]
