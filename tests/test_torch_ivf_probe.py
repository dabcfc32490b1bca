"""Parity of the fused IVF probe (kernel 5, ``kernels/ivf_probe.py``) with
the reference's ``fused_probe_topk``, on the CPU: the port's wrapper runs
its plain version on CPU tensors, the reference's Pallas kernel runs in
interpret mode (so the batches stay small: b · nprobe grid steps).

Tolerances:
- scores: rtol=1e-5, atol=1e-6 (f32 dot products summed in different
  orders; bf16 and int8 payloads are dequantized exactly the same way);
- ids: equal where the reference's scores do not tie within that tolerance
  at the cut (``core.topk.list_mismatches``); empty slots are (-inf, 0) in
  both.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ivf_probe import fused_probe_topk as j_fused
import repro_torch.core as T
from repro_torch.core.similarity import EPS, _sqrt
from repro_torch.core.topk import canonical_topk, list_mismatches
from repro_torch.kernels import ivf_probe, ops, ref

RTOL, ATOL = 1e-5, 1e-6


def _layout(c, cap, n, seed, payload="f32", empty=(0,)):
    """Posting lists with ragged fills (``empty`` cells hold nothing), ids
    a permutation, payload rows random normal (quantized for bf16/int8)."""
    rng = np.random.default_rng(seed)
    fill = rng.integers(1, cap + 1, c).astype(np.int32)
    fill[list(empty)] = 0
    ids = rng.permutation(int(fill.sum())).astype(np.int32)
    lists = np.zeros((c, cap), np.int32)
    rows = np.zeros((c, cap, n), np.float32)
    o = 0
    for j in range(c):
        lists[j, :fill[j]] = ids[o:o + fill[j]]
        rows[j, :fill[j]] = rng.normal(size=(fill[j], n))
        o += fill[j]
    scale = None
    if payload == "int8":
        scale = (np.abs(rows).max(-1) / np.float32(127)).astype(np.float32)
        rows = np.round(rows / np.maximum(scale, 1e-8)[..., None]).astype(
            np.int8)
    return lists, rows, scale, fill


def _run_both(q, probe, lists, rows, scale, fill, k, measure, sids, ok,
              payload):
    jrows = (jnp.asarray(rows).astype(jnp.bfloat16) if payload == "bf16"
             else jnp.asarray(rows))
    want = j_fused(jnp.asarray(q), jnp.asarray(probe), jnp.asarray(lists),
                   jrows, None if scale is None else jnp.asarray(scale),
                   jnp.asarray(fill), k=k, measure=measure,
                   self_ids=jnp.asarray(sids),
                   probe_ok=None if ok is None else jnp.asarray(ok),
                   interpret=True)
    trows = torch.as_tensor(rows)
    if payload == "bf16":
        trows = trows.to(torch.bfloat16)
    got = ivf_probe.fused_probe_topk(
        torch.as_tensor(q), torch.as_tensor(probe), torch.as_tensor(lists),
        trows, None if scale is None else torch.as_tensor(scale),
        torch.as_tensor(fill), k=k, measure=measure,
        self_ids=torch.as_tensor(sids),
        probe_ok=None if ok is None else torch.as_tensor(ok))
    return [np.asarray(x) for x in want], got


@pytest.mark.parametrize("measure", T.MEASURES)
@pytest.mark.parametrize("payload", ["f32", "bf16", "int8"])
def test_fused_probe_plain_version_matches_reference_kernel(measure, payload):
    """C = 7 (not a multiple of 8) with an empty cell, self ids among the
    candidates, a probe_ok mask, every payload type."""
    c, cap, n, b, nprobe, k = 7, 12, 10, 6, 3, 8
    lists, rows, scale, fill = _layout(c, cap, n, seed=1, payload=payload)
    rng = np.random.default_rng(2)
    q = rng.normal(size=(b, n)).astype(np.float32)
    probe = np.stack([rng.permutation(c)[:nprobe] for _ in range(b)]
                     ).astype(np.int32)
    sids = lists[probe[:, 0], 0].copy()  # each query's first-probed id
    sids[0] = -1
    ok = rng.random((b, nprobe)) > 0.25
    (wv, wi), (v, i) = _run_both(q, probe, lists, rows, scale, fill, k,
                                 measure, sids, ok, payload)
    bad = list_mismatches(wv, wi, v, i, RTOL, ATOL)
    assert bad.size == 0, bad
    assert not (i.numpy() == sids[:, None]).any()
    np.testing.assert_array_equal(np.isfinite(wv), torch.isfinite(v).numpy())
    assert (i.numpy()[~np.isfinite(wv)] == 0).all()  # empty slots (-inf, 0)


@pytest.mark.parametrize("measure", T.MEASURES)
def test_fused_probe_k_above_live_candidates(measure):
    """Cells of at most 2 live slots and k = 9: the tail of every list is
    empty, in canonical order in both."""
    c, cap, n, b = 5, 2, 6, 4
    lists, rows, scale, fill = _layout(c, cap, n, seed=3, empty=(1, 3))
    rng = np.random.default_rng(4)
    q = rng.normal(size=(b, n)).astype(np.float32)
    probe = np.stack([rng.permutation(c)[:3] for _ in range(b)]
                     ).astype(np.int32)
    sids = np.full(b, -1, np.int32)
    (wv, wi), (v, i) = _run_both(q, probe, lists, rows, None, fill, 9,
                                 measure, sids, None, "f32")
    np.testing.assert_allclose(v.numpy(), wv, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(i.numpy(), wi)
    assert np.isinf(wv[:, -1]).all()


def test_fused_probe_ties_break_to_the_lowest_id():
    """Duplicate payload rows score equal: the lowest id comes first, as in
    the reference kernel, whatever the probe order."""
    c, cap, n = 3, 4, 5
    base = np.random.default_rng(5).normal(size=(1, n)).astype(np.float32)
    rows = np.repeat(base[None], c * cap, axis=1).reshape(c, cap, n)
    lists = np.array([[7, 3, 11, 0], [5, 9, 1, 0], [2, 8, 4, 6]], np.int32)
    fill = np.array([3, 3, 4], np.int32)
    probe = np.array([[2, 0, 1], [1, 2, 0]], np.int32)
    q = np.random.default_rng(6).normal(size=(2, n)).astype(np.float32)
    (wv, wi), (v, i) = _run_both(q, probe, lists, rows, None, fill, 6,
                                 "cosine", np.array([-1, 2], np.int32), None,
                                 "f32")
    np.testing.assert_array_equal(i.numpy(), wi)
    assert i[0].tolist() == [1, 2, 3, 4, 5, 6]
    assert i[1].tolist() == [1, 3, 4, 5, 6, 7]


def test_fused_wrapper_never_launches_for_cpu_tensors():
    ops.reset_launches()
    lists, rows, scale, fill = _layout(4, 6, 5, seed=7)
    q = torch.zeros((3, 5))
    probe = torch.zeros((3, 2), dtype=torch.int32)
    probe[:, 1] = 1
    ivf_probe.fused_probe_topk(q, probe, torch.as_tensor(lists),
                               torch.as_tensor(rows), None,
                               torch.as_tensor(fill), k=4)
    assert ivf_probe.fused_probe_topk.launches == 0


def _probe_case(seed, b=21, c=7, cap=120, n=10, nprobe=3, payload="f32"):
    """Query rows, a probe table, self ids among the candidates and a
    probe_ok mask over a posting layout in which cells 1 and 2 share some
    payload rows (equal scores in different cells, ties by id)."""
    lists, rows, scale, fill = _layout(c, cap, n, seed=seed, payload=payload)
    m = int(min(fill[1], fill[2]))
    rows[2, :m] = rows[1, :m]
    if scale is not None:
        scale[2, :m] = scale[1, :m]
    rng = np.random.default_rng(seed + 1)
    q = rng.normal(size=(b, n)).astype(np.float32)
    q[b // 2] = q[0]  # one query twice, so two groups tie too
    probe = np.stack([rng.permutation(c)[:nprobe] for _ in range(b)]
                     ).astype(np.int32)
    sids = lists[probe[:, 0], 0].copy()
    sids[::3] = -1
    ok = (rng.random((b, nprobe)) > 0.2).astype(np.int32)
    trows = torch.as_tensor(rows)
    if payload == "bf16":
        trows = trows.to(torch.bfloat16)
    return dict(q=torch.as_tensor(q), probe=torch.as_tensor(probe),
                lists=torch.as_tensor(lists), rows=trows,
                scale=None if scale is None else torch.as_tensor(scale),
                fill=torch.as_tensor(fill), self_ids=torch.as_tensor(sids),
                probe_ok=torch.as_tensor(ok))


def _plain(case, k, measure):
    return ref.fused_probe_topk_ref(
        case["q"], case["probe"], case["lists"], case["rows"], case["scale"],
        case["fill"], k=k, measure=measure, self_ids=case["self_ids"],
        probe_ok=case["probe_ok"])


@pytest.mark.parametrize("measure", T.MEASURES)
def test_plain_probe_invariant_under_query_permutation(measure):
    """Permuting the queries (with their probe rows, self ids and masks)
    permutes the lists and changes nothing else, bitwise: the kernel may
    visit its queries in any order."""
    case = _probe_case(seed=12, payload="int8")
    perm = torch.as_tensor(np.random.default_rng(13).permutation(21))
    moved = dict(case, **{key: case[key][perm] for key in
                          ("q", "probe", "self_ids", "probe_ok")})
    v, i = _plain(case, 9, measure)
    pv, pi = _plain(moved, 9, measure)
    assert torch.equal(pv, v[perm]) and torch.equal(pi, i[perm])


# csrc/ivf_probe.cu: the row widths its instantiations pad n to, the rows a
# block stages per round, the probe entries a block sorts per segment and
# the warps of a block
PADDED_WIDTHS = (8, 16, 20, 32, 48, 64)
ROUND_ROWS, SEGMENT_ENTRIES, WARPS = 256, 1024, 8
INT_MAX = 2 ** 31 - 1


def _grouped_emulation(q, probe, lists, rows, scale, fill, *, k, measure,
                       self_ids, probe_ok, group,
                       entries=SEGMENT_ENTRIES):
    """The kernel's order of work in plain torch: blocks of ``group``
    queries in ``ivf_probe.group_order``; per segment of probe columns the
    union of their cells (in cell order, each with the mask of the queries
    that probe it; probe order at group 1); the union's live rows packed
    back to back, each dequantized, centered and normed once; rows scored
    in 32-row subchunks by the warp (query, subchunk mod splits) with the
    query zero-padded to the instantiated width; each warp's list merged
    per subchunk, the splits' lists merged at the end. Returns the lists,
    the rows staged (summed over blocks) and the most rows one block packed
    in one segment."""
    b, n = q.shape
    nprobe = probe.shape[1]
    width = next(w for w in PADDED_WIDTHS if w >= n)
    splits = WARPS // group
    order = ivf_probe.group_order(probe, group)
    order = torch.arange(b) if order is None else order

    def prep(x):  # (m, n) → padded rows and their norm term, once each
        x = x.float()
        if measure == "pearson":
            x = x - ref._row_means(x)[:, None]
        norm = ref._row_sums(x * x)
        aux = norm if measure == "euclidean" else _sqrt(norm)
        return torch.nn.functional.pad(x, (0, width - n)), norm, aux

    qs, q_norm, q_aux = prep(q)
    out_v = torch.full((b, k), float("-inf"))
    out_i = torch.zeros((b, k), dtype=torch.int32)
    cols = min(nprobe, entries // group)
    staged = most = 0
    for q0 in range(0, b, group):
        members = order[q0:q0 + group].tolist()
        best = {(g, s): (torch.full((k,), float("-inf")),
                         torch.full((k,), INT_MAX, dtype=torch.int32))
                for g in range(len(members)) for s in range(splits)}
        for j0 in range(0, nprobe, cols):
            union = {}  # cell → query mask
            for g, qi in enumerate(members):
                for j in range(j0, min(j0 + cols, nprobe)):
                    if probe_ok is None or probe_ok[qi, j]:
                        cell = int(probe[qi, j])
                        union[cell] = union.get(cell, 0) | 1 << g
            if group > 1:
                union = dict(sorted(union.items()))
            cells, slots, masks = [], [], []
            for cell, mask in union.items():
                live = min(int(fill[cell]), lists.shape[1])
                cells += [cell] * live
                slots += range(live)
                masks += [mask] * live
            if not cells:
                continue
            staged += len(cells)
            most = max(most, len(cells))
            cells, slots = torch.as_tensor(cells), torch.as_tensor(slots)
            masks = torch.as_tensor(masks)
            x = rows[cells, slots].float()
            if scale is not None:
                x = x * scale[cells, slots][:, None]
            x, norm, aux = prep(x)
            ids = lists[cells, slots]
            for r0 in range(0, len(cells), ROUND_ROWS):
                for j in range(r0, min(r0 + ROUND_ROWS, len(cells)), 32):
                    s = (j - r0) // 32 % splits
                    sub = slice(j, j + 32)
                    for g, qi in enumerate(members):
                        want = ((masks[sub] >> g) & 1).bool()
                        if self_ids is not None:
                            want &= ids[sub] != self_ids[qi]
                        if not want.any():
                            continue
                        z = torch.zeros(want.shape)
                        for d in range(width):
                            z = z + qs[qi, d] * x[sub, d]
                        if measure == "euclidean":
                            d2 = (q_norm[qi] - 2.0 * z + norm[sub]).clamp(
                                min=0.0)
                            v = 1.0 / (1.0 + _sqrt(d2))
                        else:
                            v = z / (q_aux[qi] * aux[sub]).clamp(min=EPS)
                        v = v.masked_fill(~want, float("-inf"))
                        cid = ids[sub].masked_fill(~want, INT_MAX)
                        bv, bi = best[g, s]
                        best[g, s] = canonical_topk(
                            torch.cat([bv, v]), k, ids=torch.cat([bi, cid]))
        for g, qi in enumerate(members):
            v = torch.cat([best[g, s][0] for s in range(splits)])
            i = torch.cat([best[g, s][1] for s in range(splits)])
            v, i = canonical_topk(v, k, ids=i)
            out_v[qi] = v
            out_i[qi] = torch.where(torch.isfinite(v), i, torch.zeros_like(i))
    return (out_v, out_i), staged, most


@pytest.mark.parametrize("measure", T.MEASURES)
@pytest.mark.parametrize("payload", ["f32", "bf16", "int8"])
def test_grouped_order_emulation_is_bitwise_the_plain_probe(measure,
                                                            payload):
    """The kernel's grouped order — union cells staged once per block,
    per-slot norms and roots taken once, rows visited in union order, the
    split warps' lists merged — gives the plain version's lists bitwise, at
    every group size the wrapper picks, with and without the segment split
    of the probe columns (``entries=8``: one column a segment at G = 8),
    and across two staging rounds; groups of 8 stage fewer rows than the
    queries probe."""
    case = _probe_case(seed=14, payload=payload)
    want = _plain(case, 9, measure)
    per_query = case["fill"].clamp(max=case["lists"].shape[1])[
        case["probe"].long()] * case["probe_ok"]
    probed = int(per_query.sum())
    for group in (8, 2, 1):
        for entries in (SEGMENT_ENTRIES, 8):
            got, staged, most = _grouped_emulation(
                case["q"], case["probe"], case["lists"], case["rows"],
                case["scale"], case["fill"], k=9, measure=measure,
                self_ids=case["self_ids"], probe_ok=case["probe_ok"],
                group=group, entries=entries)
            assert torch.equal(got[0], want[0]), (group, entries)
            assert torch.equal(got[1], want[1]), (group, entries)
            if group == 8 and entries == SEGMENT_ENTRIES:
                assert staged < probed and most > ROUND_ROWS
            if group == 1:
                assert staged == probed


@pytest.mark.parametrize("b,sms,group", [(5976, 132, 8), (2105, 132, 8),
                                         (2104, 132, 4), (1056, 132, 4),
                                         (1052, 132, 2), (256, 132, 1),
                                         (64, 132, 1), (1, 132, 1)])
def test_group_plan_fills_the_card(b, sms, group):
    """Queries per block: the largest of 8, 4, 2 that still gives every SM
    two blocks; the phase-6 graph build takes 8, the lifecycle's 64- and
    256-query batches 1."""
    assert ivf_probe.plan_group(b, sms) == group
    # the kernel's counting sort holds 32768 cells: past that, no groups
    assert ivf_probe.plan_group(b, sms, ivf_probe.ORDER_MAX_CELLS) == group
    assert ivf_probe.plan_group(b, sms, ivf_probe.ORDER_MAX_CELLS + 1) == 1
    probe = torch.as_tensor(np.random.default_rng(15).integers(
        0, 9, (max(b, 2), 3)).astype(np.int32))
    order = ivf_probe.group_order(probe, group)
    if group == 1:
        assert order is None
    else:  # stable by first-probed cell: a permutation, cells ascending
        assert torch.equal(torch.sort(order).values, torch.arange(len(probe)))
        first = probe[order, 0]
        assert bool((first[1:] >= first[:-1]).all())
