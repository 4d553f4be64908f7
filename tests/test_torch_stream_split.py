"""The split of the id-stream kernels (``knn_tile``, ``range_count``) into
work items, and the order-free merge and count of their partial results.

Each kernel cuts every unit's stream of ``m`` ids into segments of
consecutive positions (``knn_tile.stream_split``). ``knn_tile``'s items
keep the stream position beside each entry of their partial top-K and
merge the partial lists by the key (d2, position), in whatever order the
items finish; a top-k above ``MAX_K`` runs as passes, each after the last
key of the one before. ``range_count``'s items add integer partial counts.
The plain models below do the same in plain PyTorch, with the items taken
in a shuffled order, and must equal ``knn_tile_plain`` and
``range_count_plain`` (one stream in order) bitwise. On the card the
kernels themselves are held against the plain versions with
``STREAM_SEG`` small, so that every unit splits into many items.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import knn_tile as tknn
from repro_torch.kernels import ops
from repro_torch.kernels import range_tile as trange
from repro_torch.kernels.ref import dot3

t = torch.from_numpy


def _segments(m, seg, nseg):
    return [(s * seg, min((s + 1) * seg, m)) for s in range(nseg)]


@pytest.mark.parametrize("m,n_units,resident,min_seg", [
    (0, 3, 528, 4096),            # an empty stream: one empty item a unit
    (1, 1, 528, 4096),
    (600, 3, 2112, 37),           # short segments, m not a multiple
    (198_550, 64, 528, 4096),     # the kernel layer's 64 tiles
    (198_550, 528, 528, 4096),    # as many tiles as resident CTAs
    (198_550, 5000, 528, 4096),   # the units alone fill the card
    (4095, 2, 1056, 4096),        # shorter than the fewest ids an item
    (10_000, 7, 1, 1),            # one resident CTA
])
def test_stream_split_covers_every_position(monkeypatch, m, n_units,
                                            resident, min_seg):
    """Every position of a unit's stream lies in exactly one segment, in
    order; each segment holds at least one id (where m > 0) and at least
    ``STREAM_SEG`` unless one segment holds the whole stream; the items
    are at least the units, and no more than the target of
    ``_ITEMS_PER_CTA`` per resident CTA asks for."""
    monkeypatch.setattr(tknn, "STREAM_SEG", min_seg)
    seg, nseg = tknn.stream_split(m, n_units, resident)
    segs = _segments(m, seg, nseg)
    assert segs[0][0] == 0 and segs[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
    if m > 0:
        assert all(b > a for a, b in segs)
        assert nseg == 1 or seg >= min_seg
    else:
        assert nseg == 1
    items = n_units * nseg
    assert items >= n_units
    want = -(-tknn._ITEMS_PER_CTA * resident // n_units)
    assert nseg <= max(1, want)
    if m >= min_seg * want:       # long streams reach the target
        assert items >= tknn._ITEMS_PER_CTA * resident


def test_stream_split_reads_stream_seg(monkeypatch):
    """The fewest ids an item is the module's ``STREAM_SEG``, which the
    card tests set small so that every unit splits."""
    assert tknn.stream_split(600, 3, 2112) == (600, 1)
    monkeypatch.setattr(tknn, "STREAM_SEG", 37)
    assert tknn.stream_split(600, 3, 2112) == (38, 16)


@pytest.mark.parametrize("tile", [8, 40, 256, 264, 1000, 2048])
def test_knn_tile_row_blocks_hold_at_most_256_rows(tile):
    """knn_tile's kernel runs CTAs of at most 256 threads (two an SM, so
    that its k <= 8 list stays in registers): its row blocks cover the
    tile once, each at most 256 rows in a whole number of warps; a tile of
    32 to 256 rows in whole warps is one block of itself."""
    n_rb, rb_rows, block = tknn.row_blocks(tile, tknn._STREAM_ROWS)
    assert tknn._STREAM_ROWS == 256
    assert rb_rows <= 256 and block <= 256 and block % 32 == 0
    assert block >= rb_rows and (n_rb - 1) * rb_rows < tile <= n_rb * rb_rows
    if tile % 32 == 0 and tile <= 256:
        assert (n_rb, rb_rows, block) == (1, tile, tile)
    assert tknn.row_blocks(tile) == tknn.row_blocks(tile, tknn.MAX_ROWS)


def _stream_inputs(rng, tile, n_tiles=3, m=600, n=300):
    """Queries, points and id streams with ties: every point twice, at ids
    i and i + n, adjacent in each stream, so that many segment boundaries
    of an odd length fall between twins; a third of the queries sit on
    points (zero distances); ids past the table (clipped for the gather);
    the first 100 positions of tile 1 invalid (whole empty segments) and
    tile 2 mostly invalid (about 8 % valid)."""
    p = rng.random((n, 3)).astype(np.float32)
    pts = np.concatenate([p, p])
    q = rng.random((n_tiles * tile, 3)).astype(np.float32)
    q[::3] = pts[rng.integers(0, 2 * n, q[::3].shape[0])]
    wnd = np.empty((n_tiles, m), np.int32)
    for i in range(n_tiles):
        first = rng.integers(0, n, m // 2)
        wnd[i, 0::2] = first
        wnd[i, 1::2] = first + n
    wnd[0, 7] = 2 * n + 5                      # past the table
    wnd[1, :100] = -1
    wnd[2, rng.random(m) > 0.08] = -1
    return q, pts, wnd


def _keys(qt, points, ids, first, *, r2, skip):
    """d2 [tile, L] of the queries against stream positions first.. of
    ``ids``, +inf where the kernel keeps nothing (invalid id, d2 at or
    above the sentinel, outside r2 unless skip), by the plain version's
    arithmetic; and the positions [L]."""
    n_pts = points.shape[0]
    p = points[ids.clamp(0, n_pts - 1).long()]
    d2 = torch.clamp_min(dot3(qt, qt)[:, None] + dot3(p, p)[None, :]
                         - 2.0 * dot3(qt[:, None, :], p[None, :, :]), 0.0)
    drop = (ids < 0)[None, :] | (d2 >= torch.tensor(np.float32(tknn._BIG)))
    if not skip:
        drop = drop | (d2 > torch.tensor(np.float32(r2)))
    pos = torch.arange(first, first + ids.shape[0])
    return torch.where(drop, float("inf"), d2), pos


def _by_key(d2, pos, kk):
    """The first kk entries of each row by the key (d2, position)."""
    by_pos = torch.argsort(pos, dim=1, stable=True)
    d2, pos = d2.gather(1, by_pos), pos.gather(1, by_pos)
    by_d2 = torch.argsort(d2, dim=1, stable=True)[:, :kk]
    d2, pos = d2.gather(1, by_d2), pos.gather(1, by_d2)
    if d2.shape[1] < kk:
        pad = kk - d2.shape[1]
        d2 = torch.cat([d2, torch.full((d2.shape[0], pad), float("inf"))], 1)
        pos = torch.cat([pos, torch.full((pos.shape[0], pad), -1)], 1)
    return d2, torch.where(torch.isinf(d2), -1, pos)


def _knn_split_model(q, points, wnd, *, k, r2, skip, tile, seg, rng):
    """knn_tile as its kernel computes it: per pass of at most MAX_K
    columns, each item's partial top-K over its segment's candidates after
    the pass's last key, merged into its tile's rows by (d2, position) in
    a shuffled order of all items; the positions turned back into ids."""
    n_tiles, m = wnd.shape
    nseg = max(1, -(-m // seg))
    items = [(i, a, b) for i in range(n_tiles)
             for a, b in _segments(m, seg, nseg)]
    out_d2 = torch.full((n_tiles * tile, k), float("inf"))
    out_idx = torch.full((n_tiles * tile, k), -1, dtype=torch.int32)
    lo_d = torch.full((n_tiles * tile,), -1.0)
    lo_p = torch.full((n_tiles * tile,), -1, dtype=torch.int64)
    for col0 in range(0, k, tknn.MAX_K):
        kk = min(tknn.MAX_K, k - col0)
        held = {}
        for j in rng.permutation(len(items)):
            i, a, b = items[j]
            rows = slice(i * tile, (i + 1) * tile)
            d2, pos = _keys(q[rows], points, wnd[i, a:b], a, r2=r2,
                            skip=skip)
            pos = pos[None, :].expand_as(d2)
            later = ((d2 > lo_d[rows, None])
                     | ((d2 == lo_d[rows, None]) & (pos > lo_p[rows, None])))
            part = _by_key(torch.where(later, d2, float("inf")), pos, kk)
            if i in held:
                part = _by_key(torch.cat([held[i][0], part[0]], 1),
                               torch.cat([held[i][1], part[1]], 1), kk)
            held[i] = part
        for i, (d2, pos) in held.items():
            rows = slice(i * tile, (i + 1) * tile)
            out_d2[rows, col0:col0 + kk] = d2
            out_idx[rows, col0:col0 + kk] = torch.where(
                pos >= 0, wnd[i][pos.clamp_min(0)], -1).to(torch.int32)
            lo_d[rows], lo_p[rows] = d2[:, -1], pos[:, -1]
    return out_d2, out_idx


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("tile", [8, 40])
@pytest.mark.parametrize("k", [1, 8, 129])
def test_knn_split_model_equals_one_stream(rng, k, tile, skip):
    """Streams of 600 ids cut into items of 37 (600 is not a multiple),
    merged in a shuffled order: bitwise ``knn_tile_plain``, ties between
    twins across segment boundaries, whole segments with no valid id, a
    mostly invalid stream, k = 129 (two passes across segments) and query
    tiles of 8 and 40 included."""
    q, pts, wnd = _stream_inputs(rng, tile)
    r2 = 0.3 ** 2
    want = tknn.knn_tile_plain(t(q), t(pts), t(wnd), k=k, r2=r2,
                               skip_test=skip, tile=tile)
    got = _knn_split_model(t(q), t(pts), t(wnd), k=k, r2=r2, skip=skip,
                           tile=tile, seg=37, rng=rng)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    fin = torch.isfinite(want[0])
    assert fin.any()
    if k > 1:   # a tie on d2, ordered by position, held in some row
        tie = (want[0][:, 1:] == want[0][:, :-1]) & fin[:, 1:]
        assert tie.any()
    if k == 129:   # the second pass holds entries where nothing is
        assert fin[:, tknn.MAX_K:].any() == skip    # outside the radius


def _range_split_model(q, wnd_pos, wnd, *, r2, tile, seg, rng):
    """range_count as its kernel computes it: each item's integer count of
    its segment's valid candidates within r2, added per query in a
    shuffled order."""
    n_tiles, m = wnd.shape
    nseg = max(1, -(-m // seg))
    items = [(i, a, b) for i in range(n_tiles)
             for a, b in _segments(m, seg, nseg)]
    out = torch.zeros((n_tiles * tile,), dtype=torch.int32)
    r2_t = torch.tensor(np.float32(r2))
    for j in rng.permutation(len(items)):
        i, a, b = items[j]
        qt = q[i * tile:(i + 1) * tile]
        p = wnd_pos[i, a:b]
        d2 = torch.clamp_min(dot3(qt, qt)[:, None] + dot3(p, p)[None, :]
                             - 2.0 * dot3(qt[:, None, :], p[None, :, :]),
                             0.0)
        hit = (d2 <= r2_t) & (wnd[i, a:b] >= 0)[None, :]
        out[i * tile:(i + 1) * tile] += hit.sum(-1, dtype=torch.int32)
    return out


@pytest.mark.parametrize("tile", [8, 40])
@pytest.mark.parametrize("m", [600, 370])
def test_range_split_model_equals_one_stream(rng, m, tile):
    """Per-segment counts of items of 37 ids, summed in a shuffled order:
    bitwise ``range_count_plain``, whole empty segments and a mostly
    invalid stream included; and the wrapper on these CPU tensors is the
    plain version."""
    q, pts, wnd = _stream_inputs(rng, tile, m=m)
    wnd_pos = pts[np.clip(wnd, 0, len(pts) - 1)]
    args = (t(q), t(wnd_pos), t(wnd))
    want = trange.range_count_plain(*args, r2=0.3 ** 2, tile=tile)
    got = _range_split_model(*args, r2=0.3 ** 2, tile=tile, seg=37, rng=rng)
    assert torch.equal(got, want) and int(want.max()) > 0
    assert torch.equal(ops.range_count(*args, r2=0.3 ** 2, tile=tile), want)


# ---------------------------------------------------------------------------
# the kernels with every unit split (on the card)
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 64, 2048])
@pytest.mark.parametrize("k", [1, 8, 32, 100, 129])
def test_knn_tile_split_matches_plain_on_card(rng, monkeypatch, k, tile):
    """The kernel with items of 37 ids (every unit split into 17, merged in
    whatever order the CTAs finish) and with its own STREAM_SEG equals
    the plain version bitwise: ties across boundaries, empty segments, a
    mostly invalid stream, clipped ids, both skip flags, masked tiles (8)
    and two row blocks a tile (2048), two passes (129)."""
    _need_card()
    q, pts, wnd = _stream_inputs(rng, tile)
    args = [t(a).cuda() for a in (q, pts, wnd)]
    for skip in (False, True):
        kw = dict(k=k, r2=0.3 ** 2, skip_test=skip, tile=tile)
        want = tknn.knn_tile_plain(*args, **kw)
        for seg in (37, tknn.STREAM_SEG):
            monkeypatch.setattr(tknn, "STREAM_SEG", seg)
            before = tknn.knn_tile.launches
            got = ops.knn_tile(*args, **kw)
            torch.cuda.synchronize()
            assert tknn.knn_tile.launches == before + -(-k // tknn.MAX_K)
            assert torch.equal(got[0], want[0]) and \
                torch.equal(got[1], want[1]), (seg, skip)
    _, seg, nseg = tknn.knn_tile_items(wnd.shape[1], wnd.shape[0], tile, k)
    assert nseg >= 1 and seg * nseg >= wnd.shape[1]


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 64, 2048])
@pytest.mark.parametrize("m", [600, 20_000])
def test_range_count_split_matches_plain_on_card(rng, monkeypatch, m,
                                                 tile):
    """The kernel with items of 37 ids and with its own STREAM_SEG equals
    the plain version: counts added by atomics in any order; the position
    of an invalid id may hold anything (NaN here)."""
    _need_card()
    q, pts, wnd = _stream_inputs(rng, tile, m=m)
    wnd_pos = pts[np.clip(wnd, 0, len(pts) - 1)]
    wnd_pos[wnd < 0] = np.nan          # never read: an invalid id's slot
    args = [t(a).cuda() for a in (q, wnd_pos, wnd)]
    want = trange.range_count_plain(*args, r2=0.3 ** 2, tile=tile)
    for seg in (37, tknn.STREAM_SEG):
        monkeypatch.setattr(tknn, "STREAM_SEG", seg)
        got = ops.range_count(*args, r2=0.3 ** 2, tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(got, want), seg
