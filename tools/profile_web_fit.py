#!/usr/bin/env python3
"""Profile one ``web_fit`` step on the card, for one or more checkouts: the
registry's ``landmark_cf`` cell at P = 65,536 items and n = 128 landmarks,
with U cut by :func:`web_users` (the rule ``chip_smoke.py`` phase 19a
cuts it by, worked out once with this checkout's dry run), on star
ratings made on the card by :func:`web_ratings` (1..5 on 2% of the
cells, seed 0).

    python3 tools/profile_web_fit.py [TREE ...] [--reps 1]

Each TREE is the root of a checkout (default: this one); every tree runs in
a process of its own, importing only its own ``src`` and building its own
kernels under its own ``build/kernels``. Trees run in turns, ``--reps``
rounds, first to last then last to first (old, new, new, old). Per run it
prints one JSON line: the step's host-clock ms (two steps after a warm-up
step, each ending in a sync), then :func:`web_split` of one more step;
and d1's launches by route and its kept and replaced results where the
tree has them. Needs a CUDA card with room for the (U, 65,536) f32
ratings, and ``nvcc``.

``chip_smoke.py`` (phases 14c and 19a) and
``tools/time_masked_similarity.py`` import the generator, the cut and
the split from here.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WEB_DENSITY = 0.02  # 1-5 stars on 2% of the (user, item) cells
WEB_BLOCK = 4096  # rows generated at a time
WEB_STEP = 16384  # web_fit's users are cut to a multiple of this
# the share of the card's bytes the cut leaves to the step's arguments and
# temps (the rest: the CUDA context, the allocator's rounding, the checks)
WEB_HEADROOM = 0.8
# web_fit's step by kernel: d1's (the workspace memset, the planes, the
# moments, the finalize launch or its f32 route) and kernel 2's wide route
WEB_D1 = ("Memset", "planes_kernel", "moments_", "masked_similarity_kernel")
WEB_KERNEL2 = ("topk_prep_wide_kernel", "topk_scan_wide_kernel")


def web_ratings(u, p, device="cuda", seed=0):
    """(u, p) f32 star ratings made on ``device``, WEB_BLOCK rows at a
    time, each block from its own seeded generator."""
    import torch

    r = torch.empty((u, p), device=device)
    gen = torch.Generator(device=device)
    for b0 in range(0, u, WEB_BLOCK):
        gen.manual_seed(seed * 1_000_003 + b0)
        blk = r[b0:b0 + WEB_BLOCK]
        stars = torch.randint(1, 6, blk.shape, generator=gen, device=device)
        keep = torch.rand(blk.shape, generator=gen, device=device)
        blk.copy_(stars.float() * (keep < WEB_DENSITY))
        del stars, keep
    return r


def web_arch(**dims):
    """The registry's landmark_cf with its web_fit shape's dims replaced by
    ``dims``."""
    from repro_torch.configs import registry

    arch = registry.get("landmark_cf")
    return dataclasses.replace(arch, shapes=tuple(
        dataclasses.replace(s, dims={**s.dims, **dims})
        if s.name == "web_fit" else s for s in arch.shapes))


def web_users(total):
    """(U, bytes): the most web_fit users a card of ``total`` bytes holds,
    the largest multiple of WEB_STEP whose dry-run argument and temp bytes
    fit WEB_HEADROOM of it, and those bytes."""
    from repro_torch.launch import dryrun

    def need(u):
        c = dryrun.count_cell(web_arch(n_users=u), "web_fit")[0].memory
        return c["argument_size_in_bytes"] + c["temp_size_in_bytes"]
    u = WEB_STEP
    while need(u + WEB_STEP) <= WEB_HEADROOM * total:
        u += WEB_STEP
    return u, need(u)


def web_split(step):
    """One call of ``step`` (a web_fit step) under ``torch.profiler``, in a
    session that opens with the spin-kernel markers of
    ``obs/profile.py::profiled``: the device ms of d1's kernels (by name:
    its launches, made through ctypes, are not tied to a range), of kernel
    2's wide prep and scan, of the popularity count (the kernels launched
    inside a record_function range around ``core/selection.py::_counts``)
    and of everything else, with the device's busy and idle share of the
    step's window and the kernels by name. ``split_ms`` is None when the
    profiler lost the session's markers."""
    import torch
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function

    from repro_torch.core import selection
    from repro_torch.obs import profile as obs_profile

    inner = selection._counts

    def counted(ratings):
        with record_function("popularity_count"):
            return inner(ratings)

    selection._counts = counted
    try:
        with obs_profile.profiled() as prof:
            step()
            torch.cuda.synchronize()
    finally:
        selection._counts = inner
    kernels, lost = obs_profile.strip_markers(
        e for e in prof.events() if e.device_type == DeviceType.CUDA)
    if kernels is None:
        return {"split_ms": None, "markers_lost": lost}
    by_name, spans = {}, []
    for e in kernels:
        if e.name == "popularity_count":  # the range's own device span
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].removeprefix("void ")[:72]
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e3
    popularity = sum(e.device_time_total for e in prof.events()
                     if e.name == "popularity_count"
                     and e.device_type == DeviceType.CPU) / 1e3
    spans.sort()
    busy, end = 0.0, spans[0][0]
    for t0, t1 in spans:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    window = (end - spans[0][0]) / 1e3
    total = sum(by_name.values())
    part = {key: sum(v for n, v in by_name.items() if key in n)
            for key in WEB_D1 + WEB_KERNEL2}
    split = {"d1": sum(part[key] for key in WEB_D1),
             **{key: part[key] for key in WEB_KERNEL2},
             "popularity_count": popularity}
    split["everything_else"] = total - sum(split.values())
    return dict(split_ms=split, device_ms=total, busy_ms=busy / 1e3,
                window_ms=window, idle_share=1 - busy / 1e3 / window,
                markers_lost=lost, d1_by_kernel_ms=part,
                top_ms=dict(sorted(by_name.items(),
                                   key=lambda kv: -kv[1])[:12]))


def _one(tree: str, users: int) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch

    from repro_torch.launch import steps  # first: it imports the core
    from repro_torch.kernels import masked_similarity as ms

    cell = steps.build_cell(web_arch(n_users=users), "web_fit")
    r = web_ratings(cell.args[1].shape[0], cell.args[1].shape[1])
    cell.fn(None, r)  # builds the kernels, warms the allocator
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        cell.fn(None, r)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = getattr(ms.masked_similarity, "route_launches", {})
    for key in launches:
        launches[key] = 0
    if hasattr(ms, "route_results"):
        ms.route_results()
        for t in ms.masked_similarity.results.values():
            t.zero_()
    split = web_split(lambda: cell.fn(None, r))
    print(json.dumps({
        "tree": tree, "card": torch.cuda.get_device_name(0), "U": users,
        "P": r.shape[1], "n": 128, "step_ms": step_ms,
        "d1_route_launches": dict(launches),
        "d1_results": (ms.route_results()
                       if hasattr(ms, "route_results") else None),
        **split}), flush=True)


def main_users():
    """web_users of card 0, by this checkout's dry run, printed: the U
    every tree of a run takes."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    total = torch.cuda.get_device_properties(0).total_memory
    users, need = web_users(total)
    print(f"web_fit: U = {users} (dry-run argument + temp bytes {need} "
          f"within {WEB_HEADROOM} of the card's {total} B)", flush=True)
    return users



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", default=[str(ROOT)])
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--one", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        _one(args.one[0], int(args.one[1]))
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    users = main_users()
    for r in range(args.reps):
        for tree in (args.trees if r % 2 == 0 else args.trees[::-1]):
            subprocess.run([sys.executable, __file__, "--one", tree,
                            str(users)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
