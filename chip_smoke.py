#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each printing one line (any failure exits non-zero):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc for every ``antidote_ccrdt_tpu_torch/csrc/*.cu`` at once,
   with each kernel's registers and spills from ``-Xptxas -v``;
3. kernels: K1 (in place), K1c (out of place, on a contiguous table and
   on a stride-0 broadcast view), K2 and K3 against their plain PyTorch
   versions on the card at the main path's shapes (``torch.equal``),
   timed with CUDA events beside their byte bound and one library call
   computing the same function;
4. main path: ``DenseReplay(make_dense("topk_rmv", ...), 32)`` for 8
   rounds of 32 768 adds + 2 048 removals per replica, a sync every 4
   rounds and an observe; every apply round must launch each of the main
   path's kernels (K1c, K2, K3);
5. profile: one more round and sync of the main path under
   torch.profiler — device time by kernel and the device's idle share;
   then each kernel of phase 3 alone under torch.profiler, its device
   time without the launch (no profiler session runs before phase 4,
   whose host launches it could slow);
6. identity: a reduced seeded replay on the CPU (plain versions) and on
   the card (kernels) must end in bit-identical states;
7. batch_merge: the north-star ``batch_merge("topk_rmv", states)`` of 32
   scalar states (one DC each, 8 192 adds and 512 removals per state over
   100 000 ids, K = 100), built from seeded draws (and checked against
   the scalar ``update`` at a reduced size), held against an independent
   host set join; the converter's canonicalising K3 call (W = M <= 16, a
   half-warp a row) and every fold level's K3 join (W = 2M > 16, a warp a
   row) held against their plain versions on their full inputs and timed
   (CUDA events and device-only) beside their times before the warp
   kernel's redesign, their byte bounds and their data-dependent bounds;
   host convert, fold and extract times; a reduced ``batch_merge`` of each
   other type at its BASELINE.json replica count equal on the card and the
   CPU; both K3 paths must have launched;
8. wide rows: ``batch_merge("topk_rmv", states)`` whose capacity M = 8 400
   (> 8 192, so the converter's call at W = M and the fold's at W = 2M take
   K3's global-scratch path) against the host set join, and that path held
   against its plain version on the converter's and the first fold level's
   inputs; then the same at M = 2 000, where both calls take K3's block
   path (256 < W <= 8 192, the row in shared memory);
9. coalesced replay: ``DenseReplay.apply_coalesced`` of 4 batches at the
   main path's shapes (whole-log compaction of 139 264 ops per replica,
   then one apply that must launch K1c, K2 and K3), the coalesce and the
   apply timed apart, the peak memory of the coalesce, the op counts in
   and out, beside the same 4 batches applied one by one; the coalesced
   batch applied again with every K1c, K2 and K3 call held against its
   plain version on that call's inputs, ending in the same state; one
   coalesce under torch.profiler (device time by kernel, idle share); at a
   reduced size the coalesced ops and the applied state equal on the CPU
   and the card;
10. MONOID engines, deltas and laws: ``DenseReplay`` of average,
   wordcount and worddocumentcount (``apply_doc_ops_compact``) at
   ``benchmarks/bench_all.py``'s shapes, 4 rounds with a duplicated
   contributor in the sync after round 2, bit-identical to the same run on
   the CPU; ``make_delta``/``apply_any_delta`` on phase 9's state give it
   back bit for bit; ``coalesce_deltas`` of 3 chained wordcount deltas
   equals the interval's delta; ``check_engine_laws`` holds for the six
   registered fixtures on the card (the topk_rmv fixture's merges must
   launch K3, each call held against the plain K3) and catches the broken
   merge;
11. the kernels line, then the ok line.

Imports nothing of JAX. Without a card, or outside the repository, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SECTOR_BYTES = 32  # the device memory's access granule
INT32_OPS_PER_S = 67e12  # H100 SXM scalar 32-bit rate (the fp32 non-tensor peak)

# The main path's shapes (bench.py main(): R=32, I=100 000, B=32 768,
# Br=2 048, D=R, M=4, K=100).
R, I, B, BR, M, K = 32, 100_000, 32_768, 2_048, 4, 100
ROUNDS, SYNC_EVERY = 8, 4

# The north-star batch_merge (BASELINE.json "topk_rmv K=100 with concurrent
# add/rmv, 100k keys, 32 replicas"): N states, one DC each, uniform ids.
BM_N, BM_IDS, BM_ADDS, BM_RMVS = 32, 100_000, 8_192, 512
# The other types at their BASELINE.json replica counts, reduced in ops.
BM_OTHERS = {"topk": 8, "leaderboard": 16, "wordcount": 64, "worddocumentcount": 64, "average": 2}
# K3's times on those calls before the warp kernel's redesign, as PERF.md
# records them (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W): the
# converter's call at W = 13, then the fold's levels at W = 26.
EARLIER_K3_MS = {"convert": 1.492, "levels": [2.27, 1.15, 0.59, 0.30, 0.16]}
# Capacity of the wide-row check: past K3's shared-memory rows (8 192).
WIDE_M = 8_400
# Capacity of the block-path check: 256 < M and 2M <= 8 192.
BLOCK_M = 2_000
# Batches per coalesced round: the rounds between two syncs in phase 4.
COALESCE_K = 4


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + json.dumps(kw, sort_keys=False), flush=True)


def bound_ms(n_bytes: float, n_ops: float = 0.0):
    tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def rmv_sector_bytes(torch, sides, rmv_vc) -> int:
    """Bytes of the distinct 32-byte `rmv_vc` sectors that K3 must read:
    those of the candidates with ts > 0 and a dc in [0, D) (any other
    candidate dies, or survives, without its tombstone)."""
    D = rmv_vc.shape[-1]
    lead = rmv_vc.shape[:-1]
    row = torch.arange(rmv_vc.numel() // D, device=rmv_vc.device).view(lead + (1,))
    per = SECTOR_BYTES // rmv_vc.element_size()
    addr = [((row * D + d.long()) // per)[(t > 0) & (d >= 0) & (d < D)] for _, d, t in sides]
    return int(torch.unique(torch.cat(addr)).numel()) * SECTOR_BYTES


def max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


@contextlib.contextmanager
def held_against_plain(torch, checks: dict):
    """While open, every call the topk_rmv engine makes to K1c, K2 or K3
    also runs the kernel's plain version on the call's own arguments, and
    the two must be equal (``torch.equal``). `checks` gets one entry per
    wrapper and input shape: calls and max_abs_err. The wrappers count
    their launches as always; the plain calls count nothing."""
    from antidote_ccrdt_tpu_torch.models import topk_rmv_dense as trd
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place_plain

    def held(name, wrapper, plain, shape):
        def call(*args, **kw):
            got = wrapper(*args, **kw)
            want = plain(*args, **kw)
            got_t, want_t = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            if not all(torch.equal(x, y) for x, y in zip(got_t, want_t)):
                raise AssertionError(f"{name} at {shape(*args, **kw)} disagrees with its plain version")
            entry = checks.setdefault(f"{name} {shape(*args, **kw)}", dict(calls=0, max_abs_err=0))
            entry["calls"] += 1
            entry["max_abs_err"] = max(entry["max_abs_err"], max_abs_err(got_t, want_t))
            return got
        return call

    def k3_shape(sides, m_keep, rmv_vc=None):
        return (f"W={sum(s[0].shape[-1] for s in sides)} rows={sides[0][0][..., 0].numel()} "
                f"fused={rmv_vc is not None}")

    # The engine's names are patched, not the wrappers' own: a wrapper
    # counts its launches on its module-level name.
    patches = [
        (trd, "scatter_max_rows", held(  # dense_table.scatter_max_rows: one K1c launch
            "K1c", trd.scatter_max_rows, kernels.scatter_max_rows_copy_plain,
            lambda table, rows, upd: f"table={list(table.shape)} rows={list(rows.shape)}")),
        (trd, "delta_place", held(
            "K2", trd.delta_place, delta_place_plain, lambda *a: f"stream={list(a[3].shape)} T={a[6]} M={a[7]}")),
        (trd, "sort_slots", held("K3", trd.sort_slots, kernels.sort_slots_plain, k3_shape)),
    ]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    try:
        for mod, attr, fn in patches:
            setattr(mod, attr, fn)
        yield checks
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def device_ms(torch, fn, kernel: str, reps: int = 20) -> float:
    """Mean device time per launch of the CUDA kernel named `kernel` inside
    `fn`, from torch.profiler (launch and host time excluded), over the
    launches the profiler recorded. torch.profiler drops kernel records
    now and then, at times all of a session's: a session that recorded
    none is run again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and re.search(rf"\b{kernel}\b", e.key)]
        us, calls = sum(e.self_device_time_total for e in hits), sum(e.count for e in hits)
        if us > 0:
            break
    else:
        raise AssertionError(f"the profiler saw no device time of {kernel} in three sessions")
    if calls != reps:
        print(f"[device times] note: the profiler recorded {calls} of {reps} launches of {kernel}", flush=True)
    return us / 1e3 / calls


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)
    return smi


def phase_build():
    from antidote_ccrdt_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    secs = time.perf_counter() - t0
    regs = {}
    for name in _build.SOURCES:
        # One entry per kernel: its registers and its spills.
        regs[name] = {
            re.search(r"'(\w+)'", part).group(1): " ".join(
                re.findall(r"Used \d+ registers|\d+ bytes spill \w+", part))
            for part in _build.BUILD_LOG.get(name, "").split("Compiling entry function")[1:]
        }
    log("build", seconds=round(secs, 2), ptxas=regs)


def phase_kernels(torch):
    """K1, K1c, K2 and K3 against their plain versions at the main path's
    shapes."""
    from antidote_ccrdt_tpu_torch import registry
    from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place, delta_place_plain
    from antidote_ccrdt_tpu_torch.ops.dense_table import NEG_INF
    from antidote_ccrdt_tpu_torch.utils.benchtime import cuda_time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    D = R
    rows_out = {}
    device_jobs = []  # (label, call, kernel name), profiled after phase 5

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int32)

    # K1: tombstone scatter-max into [32, 100k, 32], Br=2048 per replica,
    # with duplicate and out-of-range rows.
    table = ri(0, 1 << 20, (R, I, D))
    rows = ri(0, I, (R, BR))
    rows[:, ::8] = rows[:, :1]
    rows[:, 1::97] = -1
    rows[:, 2::97] = I
    upd = ri(0, 1 << 20, (R, BR, D))
    got = kernels.scatter_max_rows_(table.clone(), rows, upd)
    want = kernels.scatter_max_rows_plain_(table.clone(), rows, upd)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K1 scatter_max_rows disagrees with its plain version")
    valid = (rows >= 0) & (rows < I)
    flat = (torch.arange(R, device=dev)[:, None] * I + rows.long())[valid]
    n_rows = int(torch.unique(flat).numel())
    idx2 = flat[:, None].expand(-1, D).contiguous()
    src2 = upd[valid].contiguous()
    buf = table.clone()
    b, by = bound_ms(2 * n_rows * D * 4 + R * BR * 4 + R * BR * D * 4)
    rows_out["scatter_max_rows"] = dict(
        max_abs_err=max_abs_err([got], [want]),
        ms=cuda_time_ms(lambda: kernels.scatter_max_rows_(buf, rows, upd)),
        plain_ms=cuda_time_ms(lambda: kernels.scatter_max_rows_plain_(buf, rows, upd)),
        bound_ms=b, bound_by=by,
        library_ms=cuda_time_ms(lambda: buf.view(R * I, D).scatter_reduce_(0, idx2, src2, "amax")),
    )
    log("kernel K1", touched_rows=n_rows, copy_ms=cuda_time_ms(lambda: table.clone()),
        copy_bound_ms=bound_ms(2 * R * I * D * 4)[0], **rows_out["scatter_max_rows"])
    device_jobs.append(("K1", lambda: kernels.scatter_max_rows_(table, rows, upd), "scatter_max_rows_kernel"))
    device_jobs.append(("K1 library", lambda b=buf, i=idx2, u=src2: b.view(R * I, D).scatter_reduce_(0, i, u, "amax"),
                        "_scatter_gather_elementwise_kernel"))
    del got, want

    # K1c: the same scatter-max out of place, on a contiguous table and on
    # DenseReplay's broadcast view after a sync (one row, replica stride 0).
    small = R * BR * 4 + R * BR * D * 4
    for form, tab in (("contiguous", table), ("view", table[:1].expand(R, I, D))):
        before = tab.clone()
        got = kernels.scatter_max_rows_copy(tab, rows, upd)
        want = kernels.scatter_max_rows_copy_plain(tab, rows, upd)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K1c scatter_max_rows_copy ({form}) disagrees with its plain version")
        if not torch.equal(tab, before):
            raise AssertionError(f"K1c scatter_max_rows_copy ({form}) wrote its input")
        read = (1 if form == "view" else R) * I * D * 4
        b, by = bound_ms(read + R * I * D * 4 + small)
        entry = dict(
            max_abs_err=max_abs_err([got], [want]),
            ms=cuda_time_ms(lambda: kernels.scatter_max_rows_copy(tab, rows, upd)),
            plain_ms=cuda_time_ms(lambda: kernels.scatter_max_rows_copy_plain(tab, rows, upd)),
            bound_ms=b, bound_by=by,
            # One out-of-place call (after a reshape, which copies a view).
            library_ms=cuda_time_ms(lambda: tab.reshape(R * I, D).scatter_reduce(0, idx2, src2, "amax")),
        )
        log(f"kernel K1c {form}", **entry)
        device_jobs.append((f"K1c {form}", lambda tab=tab: kernels.scatter_max_rows_copy(tab, rows, upd),
                            "scatter_max_rows_copy_kernel"))
        if form == "contiguous":
            rows_out["scatter_max_rows_copy"] = entry
        del got, want, before

    # K2: a real sorted add stream of the main path's first batch.
    eng = registry.make_dense("topk_rmv", n_ids=I, n_dcs=D, size=K, slots_per_id=M)
    gen = TopkRmvEffectGen(Workload(R, I, zipf_a=1.2, score_max=100_000, seed=7))
    st = eng.add_stream(gen.next_batch(B, BR), 1)
    args = (st.score, st.ts, st.dc, st.kid, st.rank, st.keep)  # the sorted kid, as the engine passes it
    got = delta_place(*args, I, M)
    want = delta_place_plain(*args, I, M)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError("K2 delta_place disagrees with its plain version")
    addr = ((torch.arange(R, device=dev)[:, None] * I + st.kid.long()) * M + st.rank.long())[st.keep]
    vals = [st.score[st.keep], st.dc[st.keep], st.ts[st.keep]]

    def library_k2():
        for v, fill in zip(vals, (NEG_INF, 0, 0)):
            torch.full((R * I * M,), fill, dtype=torch.int32, device=dev).index_put_((addr,), v)

    b, by = bound_ms(3 * R * I * M * 4 + R * B * (5 * 4 + 1))
    rows_out["delta_place"] = dict(
        max_abs_err=max_abs_err(got, want),
        ms=cuda_time_ms(lambda: delta_place(*args, I, M)),
        plain_ms=cuda_time_ms(lambda: delta_place_plain(*args, I, M)),
        bound_ms=b, bound_by=by, library_ms=cuda_time_ms(library_k2),
    )
    tables = [torch.empty((R, I, M), dtype=torch.int32, device=dev) for _ in range(3)]
    device_jobs.append(("K2", lambda: delta_place(*args, I, M), "delta_place_kernel"))
    log("kernel K2", kept=int(st.keep.sum()),
        # The writes alone: three torch fills of the same tables.
        fill_ms=cuda_time_ms(lambda: [x.fill_(0) for x in tables]),
        **rows_out["delta_place"])
    del tables
    del got, want

    # K3: [32, 1, 100k] rows of 2 x 4 candidates against rmv_vc
    # [32, 1, 100k, 32], fused and unfused. Each side is a canonical slot
    # list (sorted, dup-free), as the state and the delta table are.
    lead = (R, 1, I)

    def side():
        ts = torch.where(ri(0, 4, lead + (M,)) == 0, 0, ri(1, 1 << 20, lead + (M,)))
        sc = torch.where(ts > 0, ri(1, 100_000, lead + (M,)), NEG_INF).to(torch.int32)
        dc = torch.where(ts > 0, ri(0, D, lead + (M,)), 0).to(torch.int32)
        return kernels.sort_slots_plain([(sc, dc, ts.to(torch.int32))], M)[:3]

    sides = [side(), side()]
    rmv_vc = ri(0, 1 << 20, lead + (D,))
    n = R * I
    packed = torch.cat([s[0].long() * 2**32 + s[2].long() for s in sides], dim=-1)
    for fused in (True, False):
        vc = rmv_vc if fused else None
        got = kernels.sort_slots(sides, M, rmv_vc=vc)
        want = kernels.sort_slots_plain(sides, M, vc)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"K3 sort_slots (fused={fused}) disagrees with its plain version")
        n_bytes = 6 * n * M * 4 + 3 * n * M * 4 + n * 4 + (n * D * 4 if fused else 0)
        b, by = bound_ms(n_bytes, n * (2 * 19 * 12 + 8 * 6))
        # The bound with only the tombstone sectors the live candidates need.
        data_bound = bound_ms(n_bytes - n * D * 4 + rmv_sector_bytes(torch, sides, rmv_vc), 0)[0] if fused else b
        entry = dict(
            max_abs_err=max_abs_err(got, want),
            ms=cuda_time_ms(lambda: kernels.sort_slots(sides, M, rmv_vc=vc)),
            plain_ms=cuda_time_ms(lambda: kernels.sort_slots_plain(sides, M, vc), reps=3, warmup=1),
            bound_ms=b, bound_by=by,
            library_ms=cuda_time_ms(lambda: torch.sort(packed, dim=-1, descending=True)),
        )
        log(f"kernel K3 fused={fused}", live=int((got[2] > 0).sum()), data_bound_ms=data_bound, **entry)
        device_jobs.append((f"K3 fused={fused}", lambda vc=vc: kernels.sort_slots(sides, M, rmv_vc=vc),
                            "sort_slots_kernel"))
        if fused:
            rows_out["sort_slots"] = entry
    return rows_out, device_jobs


def phase_main_path(torch, card: str):
    """The port's main path at full width, through the user's entry points."""
    from antidote_ccrdt_tpu_torch import registry
    from antidote_ccrdt_tpu_torch.harness.dense_replay import DenseReplay
    from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place
    from antidote_ccrdt_tpu_torch.utils.benchtime import sync

    dense = registry.make_dense("topk_rmv", n_ids=I, n_dcs=R, size=K, slots_per_id=M)
    rp = DenseReplay(dense, R)
    gen = TopkRmvEffectGen(Workload(R, I, zipf_a=1.2, score_max=100_000, seed=7))
    batches = [gen.next_batch(B, BR) for _ in range(ROUNDS)]  # set-up, on the card
    wrappers = {
        "scatter_max_rows": kernels.scatter_max_rows_,
        "scatter_max_rows_copy": kernels.scatter_max_rows_copy,
        "delta_place": delta_place,
        "sort_slots": kernels.sort_slots,
    }
    main_path = ("scatter_max_rows_copy", "delta_place", "sort_slots")
    for w in wrappers.values():
        w.launches = 0
    # Earlier phases' garbage is collected here, not by a full collection
    # that the rounds' allocations would trigger inside the timed region.
    gc.collect()
    sync()
    # Phase 3's inputs stay allocated until their device times are taken
    # after phase 5: the main path's peak is counted above them.
    torch.cuda.reset_peak_memory_stats()
    mem_base = torch.cuda.memory_allocated()
    apply_ms, sync_ms, per_round = [], [], []
    t_all = time.perf_counter()
    for rnd, ops in enumerate(batches):
        before = {n: w.launches for n, w in wrappers.items()}
        t0 = time.perf_counter()
        rp.apply(ops)
        sync()
        apply_ms.append((time.perf_counter() - t0) * 1e3)
        per_round.append({n: w.launches - before[n] for n, w in wrappers.items()})
        if (rnd + 1) % SYNC_EVERY == 0:
            t0 = time.perf_counter()
            rp.sync()
            sync()
            sync_ms.append((time.perf_counter() - t0) * 1e3)
    obs = rp.observe()
    sync()
    total_s = time.perf_counter() - t_all
    launches = {n: w.launches for n, w in wrappers.items()}
    for rnd, got in enumerate(per_round):
        if min(got[n] for n in main_path) < 1:
            raise AssertionError(f"apply round {rnd} did not launch every main-path kernel: {got}")
    if tuple(obs.ids.shape) != (R, 1, K) or not bool(obs.valid.any()):
        raise AssertionError("empty or misshapen observable")
    if not rp.converged():
        raise AssertionError("replicas did not converge after the sync")
    if bool(rp.state.lossy.any()):
        print("[main] note: lossy capacity overflow flagged", flush=True)
    apply_sorted = sorted(apply_ms)
    merges = R * (B + BR) * ROUNDS
    log("main", card=card, rounds=ROUNDS, syncs=len(sync_ms), launches=launches,
        launches_per_apply=per_round[-1],
        apply_ms=apply_ms, sync_ms=sync_ms,
        p50_round_ms=apply_sorted[len(apply_sorted) // 2],
        merges_per_s=merges / total_s,
        apply_merges_per_s=merges / (sum(apply_ms) / 1e3),
        valid_observed=int(obs.valid.sum()),
        peak_mem_gb=(torch.cuda.max_memory_allocated() - mem_base) / 1e9)
    return launches, rp, gen


def phase_profile(torch, rp, ops):
    """One more apply round and a sync of the main path under
    torch.profiler: device time by kernel, and the device's idle share
    (profiler on, so the host side runs slower than in phase 4)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from antidote_ccrdt_tpu_torch.utils.benchtime import sync

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rp.apply(ops)
        rp.sync()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernels, copies and memsets are the events on the device; the aten
    # ops that launched them carry the same time again, so they are left out.
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    log("profile", wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
        top=[{"name": e.key[:70], "ms": e.self_device_time_total / 1e3, "calls": e.count} for e in top])


def phase_identity(torch):
    """A reduced seeded replay on the CPU and on the card: same bits."""
    from antidote_ccrdt_tpu_torch import convert, registry
    from antidote_ccrdt_tpu_torch.harness.dense_replay import DenseReplay
    from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload

    r, i, b, br = 4, 4096, 2048, 128

    def run(device):
        dense = registry.make_dense("topk_rmv", n_ids=i, n_dcs=r, size=K, slots_per_id=M, device=device)
        rp = DenseReplay(dense, r)
        gen = TopkRmvEffectGen(Workload(r, i, zipf_a=1.2, score_max=1000, seed=11), device=device)
        for rnd in range(4):
            rp.apply(gen.next_batch(b, br))
            if rnd == 1:
                rp.sync([0, 0, 2])
        rp.sync()
        return convert.to_numpy(rp.state), convert.to_numpy(rp.observe())

    cpu, card = run("cpu"), run("cuda")
    import numpy as np

    for part_cpu, part_card in zip(cpu, card):
        for name in part_cpu:
            if not np.array_equal(part_cpu[name], part_card[name]):
                raise AssertionError(f"CPU and card disagree on {name}")
    log("identity", replicas=r, ids=i, adds=b, rmvs=br, rounds=4,
        fields=sorted(cpu[0]) + [f"observe.{k}" for k in cpu[1]], bit_identical=True)


def phase_batch_merge(torch, card: str, dev: str = "cuda"):
    """The north-star batch_merge through the entry point, its K3 joins at
    W = 2M on the wide path, and the other types on the card and the CPU."""
    import numpy as np

    from antidote_ccrdt_tpu_torch import batch_merge, registry
    from antidote_ccrdt_tpu_torch.core import batch_merge as bm
    from antidote_ccrdt_tpu_torch.harness import scalar_states as ss
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place
    from antidote_ccrdt_tpu_torch.utils.benchtime import cuda_time_ms, sync

    # The one-pass construction against the scalar update, at a reduced size.
    small = ss.topk_rmv_effects(4, 3_000, 600, 40, seed=5)
    eng = registry.scalar("topk_rmv")
    if [ss.apply_effects("topk_rmv", eng.new(K), e) for e in small] != [ss.topk_rmv_direct(e, K) for e in small]:
        raise AssertionError("topk_rmv_direct disagrees with the scalar update")
    t0 = time.perf_counter()
    effects = ss.topk_rmv_effects(BM_N, BM_IDS, BM_ADDS, BM_RMVS, seed=13)
    states = [ss.topk_rmv_direct(e, K) for e in effects]
    build_s = time.perf_counter() - t0
    del effects

    wrappers = [kernels.scatter_max_rows_, kernels.scatter_max_rows_copy, delta_place, kernels.sort_slots]
    for w in wrappers:
        w.launches = 0
    kernels.sort_slots.wide_launches = 0
    kernels.sort_slots.global_launches = 0
    sync()
    t0 = time.perf_counter()
    merged = batch_merge("topk_rmv", states, device=dev)
    sync()
    call_s = time.perf_counter() - t0
    launches = {"sort_slots": kernels.sort_slots.launches, "sort_slots_wide": kernels.sort_slots.wide_launches,
                "sort_slots_global": kernels.sort_slots.global_launches,
                "scatter_max_rows": kernels.scatter_max_rows_.launches,
                "scatter_max_rows_copy": kernels.scatter_max_rows_copy.launches, "delta_place": delta_place.launches}
    if launches["sort_slots_wide"] < 1 or launches["sort_slots"] < 1:
        raise AssertionError(f"batch_merge did not launch both of K3's paths (W = M, W = 2M): {launches}")
    t0 = time.perf_counter()
    want = ss.topk_rmv_set_join(states)
    join_s = time.perf_counter() - t0
    if merged != want:
        raise AssertionError("batch_merge disagrees with the host set join")

    # The same call in its three stages, each timed. The converter's
    # canonicalising K3 call (W = M) and each fold level's K3 join (W = 2M)
    # are held against their plain versions on their full inputs, and timed
    # alone, by CUDA events and device-only.
    sync()
    t0 = time.perf_counter()
    dense, batch, ids, dcs = bm.topk_rmv_to_dense(states, dev)
    sync()
    convert_s = time.perf_counter() - t0
    batch_gb = bm.tree_nbytes(batch) / 1e9
    Mb, U, D = dense.M, len(ids), len(dcs)
    if not 8 < Mb <= 16:
        raise AssertionError(f"M = {Mb}: the converter's call would not take K3's half-warp path")
    raw = bm.topk_rmv_tables(states, dev)[0]
    side = [(raw.slot_score, raw.slot_dc, raw.slot_ts)]
    del raw
    got = kernels.sort_slots(side, Mb)
    ref = kernels.sort_slots_plain(side, Mb)
    sync()
    if not all(torch.equal(x, y) for x, y in zip(got, ref)):
        raise AssertionError(f"K3 at W = M = {Mb} (the converter's call) disagrees with its plain version")
    if not all(torch.equal(x, y) for x, y in zip(got, (batch.slot_score, batch.slot_dc, batch.slot_ts))):
        raise AssertionError("the converter's canonical rows differ from K3's on the same tables")
    rows = BM_N * U
    b, by = bound_ms(rows * 4 * (3 * Mb + 3 * Mb + 1))
    canon = dict(W=Mb, rows=rows, max_abs_err=max_abs_err(got, ref),
                 # The rows K3 sorts; the others (absent ids) are the fill.
                 sorted_share=float((side[0][2] > 0).any(-1).float().mean()),
                 ms=cuda_time_ms(lambda: kernels.sort_slots(side, Mb)),
                 device_ms=device_ms(torch, lambda: kernels.sort_slots(side, Mb), "sort_slots_warp_kernel", reps=5),
                 earlier_ms=EARLIER_K3_MS["convert"],
                 plain_ms=cuda_time_ms(lambda: kernels.sort_slots_plain(side, Mb), reps=3, warmup=1),
                 bound_ms=b, bound_by=by)
    del got, ref, side
    levels, err = [], 0
    n = BM_N
    fold_ms = 0.0
    while n > 1:
        half = n // 2
        lhs = bm._tree_map(lambda x: x[:half], batch)
        rhs = bm._tree_map(lambda x: x[half:2 * half], batch)
        rmv = torch.maximum(lhs.rmv_vc, rhs.rmv_vc)
        sides = [(lhs.slot_score, lhs.slot_dc, lhs.slot_ts), (rhs.slot_score, rhs.slot_dc, rhs.slot_ts)]
        rows = half * U
        got = kernels.sort_slots(sides, Mb, rmv_vc=rmv)
        ref = kernels.sort_slots_plain(sides, Mb, rmv)
        sync()
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            raise AssertionError(f"K3 wide disagrees with its plain version at fold level n={n}")
        err = max(err, max_abs_err(got, ref))
        del got, ref
        slot_bytes = rows * 4 * (2 * 3 * Mb + 3 * Mb + 1)
        b, by = bound_ms(slot_bytes + rows * D * 4)
        k = len(levels)
        lv = dict(n=n, rows=rows, W=2 * Mb,
                  # The rows K3 sorts: those with a candidate of ts > 0.
                  sorted_share=float(((lhs.slot_ts > 0).any(-1) | (rhs.slot_ts > 0).any(-1)).float().mean()),
                  ms=cuda_time_ms(lambda: kernels.sort_slots(sides, Mb, rmv_vc=rmv)),
                  device_ms=device_ms(torch, lambda: kernels.sort_slots(sides, Mb, rmv_vc=rmv),
                                      "sort_slots_warp_kernel", reps=5),
                  earlier_ms=EARLIER_K3_MS["levels"][k] if k < len(EARLIER_K3_MS["levels"]) else None,
                  bound_ms=b, bound_by=by,
                  data_bound_ms=bound_ms(slot_bytes + rmv_sector_bytes(torch, sides, rmv))[0])
        if n == BM_N:
            lv["plain_ms"] = cuda_time_ms(lambda: kernels.sort_slots_plain(sides, Mb, rmv), reps=3, warmup=1)
        sync()
        t0 = time.perf_counter()
        batch = dense.merge(lhs, rhs)
        sync()
        lv["merge_ms"] = (time.perf_counter() - t0) * 1e3
        fold_ms += lv["merge_ms"]
        levels.append(lv)
        n = half
    t0 = time.perf_counter()
    again = bm.topk_rmv_from_dense(batch, ids, dcs, K)
    extract_s = time.perf_counter() - t0
    if again != merged:
        raise AssertionError("the staged batch_merge disagrees with the entry point")
    live = sum(map(len, merged.masked.values()))
    log("batch_merge topk_rmv", card=card, states=BM_N, ids=U, dcs=D, M=Mb, K=K, build_s=build_s,
        call_s=call_s, merges_per_s=BM_N * U / call_s, convert_s=convert_s, fold_ms=fold_ms,
        extract_s=extract_s, set_join_s=join_s, batch_gb=batch_gb,
        live_adds=live, removals=len(merged.removals), observed=len(merged.observed), launches=launches,
        canonicalise=canon, levels=levels)

    # The other types, reduced, at their BASELINE.json replica counts.
    others = {}
    for name, n_rep in BM_OTHERS.items():
        kw = {"topk": dict(n_ops=4000, n_ids=10_000), "leaderboard": dict(n_ops=600, n_ids=100_000)}.get(name, {})
        sts = ss.seeded_states(name, n_rep, seed=21, size=K, **kw)
        t0 = time.perf_counter()
        on_card = batch_merge(name, sts, device=dev)
        sync()
        card_s = time.perf_counter() - t0
        if on_card != batch_merge(name, sts, device="cpu"):
            raise AssertionError(f"batch_merge({name!r}) differs between the card and the CPU")
        others[name] = dict(replicas=n_rep, s=card_s)
    log("batch_merge others", **others)
    first = levels[0]
    wide = dict(max_abs_err=err, ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
                bound_by=first["bound_by"], library_ms=None)
    narrow = {k: canon[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
    return launches, wide, dict(narrow, library_ms=None)


def phase_wide_rows(torch, card: str, m: int, counter: str, kernel: str, dev: str = "cuda"):
    """batch_merge at capacity M = `m` (the converter's K3 call at W = m,
    the fold's at W = 2m), and the K3 path those calls take (its launches
    in `counter`, its CUDA kernel `kernel`) against its plain version on
    the converter's and the first fold level's inputs."""
    from antidote_ccrdt_tpu_torch import batch_merge
    from antidote_ccrdt_tpu_torch.core import batch_merge as bm
    from antidote_ccrdt_tpu_torch.harness import scalar_states as ss
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.utils.benchtime import cuda_time_ms, sync

    states = ss.topk_rmv_capacity_states(m)
    counters = ("launches", "wide_launches", "block_launches", "global_launches")
    for c in counters:
        setattr(kernels.sort_slots, c, 0)
    sync()
    t0 = time.perf_counter()
    merged = batch_merge("topk_rmv", states, device=dev)
    sync()
    call_s = time.perf_counter() - t0
    launches = {c: getattr(kernels.sort_slots, c) for c in counters}
    if launches[counter] < 2:
        raise AssertionError(f"batch_merge at M = {m} did not launch K3's {counter} path twice: {launches}")
    if merged != ss.topk_rmv_set_join(states):
        raise AssertionError(f"batch_merge at M = {m} disagrees with the host set join")

    raw = bm.topk_rmv_tables(states, dev)[0]
    Mb = raw.slot_ts.shape[-1]
    dense, batch, ids, _ = bm.topk_rmv_to_dense(states, dev)
    half = batch.slot_ts.shape[0] // 2
    lhs = bm._tree_map(lambda x: x[:half], batch)
    rhs = bm._tree_map(lambda x: x[half:2 * half], batch)
    rmv = torch.maximum(lhs.rmv_vc, rhs.rmv_vc)
    D = rmv.shape[-1]
    calls = {
        "convert": ([(raw.slot_score, raw.slot_dc, raw.slot_ts)], None, raw.slot_ts.numel() // Mb, Mb),
        "fold": ([(lhs.slot_score, lhs.slot_dc, lhs.slot_ts), (rhs.slot_score, rhs.slot_dc, rhs.slot_ts)],
                 rmv, rmv.numel() // D, 2 * Mb),
    }
    out = {}
    for label, (sides, vc, rows, W) in calls.items():
        got = kernels.sort_slots(sides, Mb, rmv_vc=vc)
        ref = kernels.sort_slots_plain(sides, Mb, vc)
        sync()
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            raise AssertionError(f"K3's {counter} path ({label}, W = {W}) disagrees with its plain version")
        # Bytes, or the bitonic network's compare-exchanges (about 12
        # integer operations each) over the row padded to P = 2^k.
        lg = (W - 1).bit_length()
        b, by = bound_ms(rows * 4 * (3 * W + (D if vc is not None else 0) + 3 * Mb + 1),
                         rows * (1 << (lg - 1)) * lg * (lg + 1) // 2 * 12)
        out[label] = dict(W=W, rows=rows, max_abs_err=max_abs_err(got, ref),
                          ms=cuda_time_ms(lambda: kernels.sort_slots(sides, Mb, rmv_vc=vc), reps=5, warmup=1),
                          device_ms=device_ms(torch, lambda: kernels.sort_slots(sides, Mb, rmv_vc=vc), kernel, reps=5),
                          plain_ms=cuda_time_ms(lambda: kernels.sort_slots_plain(sides, Mb, vc), reps=3, warmup=1),
                          bound_ms=b, bound_by=by)
    log("wide rows", card=card, M=Mb, path=counter, states=len(states), ids=len(ids), call_s=call_s,
        launches=launches, **out)
    fold = out["fold"]
    row = dict(max_abs_err=max(o["max_abs_err"] for o in out.values()), ms=fold["ms"], plain_ms=fold["plain_ms"],
               bound_ms=fold["bound_ms"], bound_by=fold["bound_by"], library_ms=None)
    return launches[counter], row


def phase_coalesced(torch, card: str, dev: str = "cuda"):
    """The coalesced replay at the main path's shapes: COALESCE_K batches
    fused by whole-log compaction and applied as one round."""
    import numpy as np

    from antidote_ccrdt_tpu_torch import convert, registry
    from antidote_ccrdt_tpu_torch.harness.dense_replay import DenseReplay
    from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place
    from antidote_ccrdt_tpu_torch.utils.benchtime import cuda_time_ms, sync
    from antidote_ccrdt_tpu_torch.utils.tree import leaves

    dense = registry.make_dense("topk_rmv", n_ids=I, n_dcs=R, size=K, slots_per_id=M, device=dev)
    gen = TopkRmvEffectGen(Workload(R, I, zipf_a=1.2, score_max=100_000, seed=7), device=dev)
    batches = [gen.next_batch(B, BR) for _ in range(COALESCE_K)]  # set-up, on the card

    # The same batches one round each, for comparison.
    gc.collect()
    seq = DenseReplay(dense, R)
    seq_ms = []
    for ops in batches:
        sync()
        t0 = time.perf_counter()
        seq.apply(ops)
        sync()
        seq_ms.append((time.perf_counter() - t0) * 1e3)

    wrappers = {"scatter_max_rows_copy": kernels.scatter_max_rows_copy, "delta_place": delta_place,
                "sort_slots": kernels.sort_slots}
    rp = DenseReplay(dense, R)
    prev = rp.state
    for w in wrappers.values():
        w.launches = 0
    sync()
    t0 = time.perf_counter()
    rp.apply_coalesced(batches)
    sync()
    round_ms = (time.perf_counter() - t0) * 1e3
    launches = {n: w.launches for n, w in wrappers.items()}
    if min(launches.values()) < 1:
        raise AssertionError(f"the coalesced apply did not launch K1c, K2 and K3: {launches}")
    ops_in, ops_out = rp.metrics.counters["coalesce_ops_in"], rp.metrics.counters["coalesce_ops_out"]

    # The coalesce alone: its peak memory above what it was given, and its
    # time; then the apply of its output alone.
    sync()
    torch.cuda.reset_peak_memory_stats()
    mem_base = torch.cuda.memory_allocated()
    fused, n_add, n_rmv = dense.coalesce_ops(batches)
    sync()
    peak_gb = (torch.cuda.max_memory_allocated() - mem_base) / 1e9
    coalesce_ms = cuda_time_ms(lambda: dense.coalesce_ops(batches), reps=3, warmup=1)
    start = dense.init(R)
    apply_ms = cuda_time_ms(lambda: dense.apply_ops(start, fused, collect_dominated="table"), reps=3, warmup=1)
    one_apply_ms = cuda_time_ms(lambda: dense.apply_ops(start, batches[0], collect_dominated="table"),
                                reps=3, warmup=1)
    # Where the coalesce's device time goes: one call under torch.profiler.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dense.coalesce_ops(batches)
        sync()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    top = sorted(on_card, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    log("coalesce profile", wall_ms=prof_wall_ms, device_busy_ms=busy_ms,
        idle_share=1 - busy_ms / prof_wall_ms if prof_wall_ms else None,
        top=[{"name": e.key[:70], "ms": e.self_device_time_total / 1e3, "calls": e.count} for e in top])
    # Every kernel call of the coalesced apply held against its plain
    # version on that call's own inputs: the coalesced batch, applied
    # again to the state the timed round started from, must end in the
    # timed round's state.
    held = {}
    with held_against_plain(torch, held):
        again, _ = dense.apply_ops(prev, fused, **getattr(dense, "replication_extras_kwargs", {}))
    sync()
    if not all(torch.equal(x, y) for x, y in zip(leaves(again), leaves(rp.state))):
        raise AssertionError("the coalesced batch applied again ends in another state than the coalesced round")
    if {k.split()[0] for k in held} != {"K1c", "K2", "K3"}:
        raise AssertionError(f"the coalesced apply did not call K1c, K2 and K3 under the check: {sorted(held)}")
    del again
    lossy_seq, lossy_c = int(seq.state.lossy.sum()), int(rp.state.lossy.sum())
    equal = dense.equal(seq.state, rp.state)
    log("coalesced", card=card, batches=COALESCE_K, log_rows=int(fused.add_key.shape[1] + fused.rmv_key.shape[1]),
        launches=launches, held_against_plain=held, round_ms=round_ms, coalesce_ms=coalesce_ms, apply_ms=apply_ms,
        one_batch_apply_ms=one_apply_ms, sequential_round_ms=seq_ms,
        ops_in=ops_in, ops_out=ops_out, out_over_in=ops_out / ops_in,
        live_adds=int(n_add.sum()), live_rmvs=int(n_rmv.sum()), coalesce_peak_gb=peak_gb,
        equal_to_sequential=equal, lossy_replicas_sequential=lossy_seq, lossy_replicas_coalesced=lossy_c)
    del seq, fused, start

    # Bit identity, CPU against card, at the reduced identity shapes.
    r, i, b, br = 4, 4096, 2048, 128

    def run(device):
        d = registry.make_dense("topk_rmv", n_ids=i, n_dcs=r, size=K, slots_per_id=M, device=device)
        g = TopkRmvEffectGen(Workload(r, i, zipf_a=1.2, score_max=1000, seed=11), device=device)
        bs = [g.next_batch(b, br) for _ in range(COALESCE_K)]
        ops, na, nr = d.coalesce_ops(bs)
        st, _ = d.apply_ops(d.init(r), ops, collect_dominated="table")
        return convert.to_numpy(ops), na, nr, convert.to_numpy(st)

    cpu, dev_out = run("cpu"), run(dev)
    for part_cpu, part_card in zip(cpu, dev_out):
        parts = part_cpu.items() if isinstance(part_cpu, dict) else [("counts", part_cpu)]
        for name, value in parts:
            other = part_card[name] if isinstance(part_card, dict) else part_card
            if not np.array_equal(value, other):
                raise AssertionError(f"coalesced round: CPU and card disagree on {name}")
    log("coalesced identity", replicas=r, ids=i, adds=b, rmvs=br, batches=COALESCE_K, bit_identical=True)
    return dense, prev, rp.state


def phase_monoid(torch, card: str, topk_rmv, dev: str = "cuda"):
    """The MONOID engines' replays on the card against the CPU, deltas and
    their coalescing, and the merge laws on the card."""
    import numpy as np

    from antidote_ccrdt_tpu_torch import convert, registry
    from antidote_ccrdt_tpu_torch.harness.dense_replay import DenseReplay
    from antidote_ccrdt_tpu_torch.models import average as av
    from antidote_ccrdt_tpu_torch.models import wordcount as wc
    from antidote_ccrdt_tpu_torch.ops import kernels, laws
    from antidote_ccrdt_tpu_torch.ops.compaction import coalesce_deltas
    from antidote_ccrdt_tpu_torch.parallel import delta
    from antidote_ccrdt_tpu_torch.utils.benchtime import sync
    from antidote_ccrdt_tpu_torch.utils.tree import leaves

    def t(a, device):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # benchmarks/bench_all.py's shapes: average (R, NK, B) = (2, 1000, 2^20),
    # wordcount (64, V = 2^16, 2^16 Zipf(1.1) tokens), worddocumentcount
    # (64, V = 2^16, 512 documents x 64 words of a 50 000-word vocabulary).
    words = [f"w{k}" for k in range(50_000)]
    table = wc.fnv1a_buckets(words, 1 << 16)

    def average_round(rng, device):
        R_, NK_, B_ = 2, 1000, 1 << 20
        return av.AverageOps(key=t(rng.integers(0, NK_, (R_, B_)).astype(np.int32), device),
                             value=t(rng.integers(-100, 100, (R_, B_)).astype(np.int32), device),
                             count=t(rng.integers(1, 3, (R_, B_)).astype(np.int32), device))

    def wordcount_round(rng, device):
        raw = rng.zipf(1.1, size=(64, 1 << 16))
        return wc.WordcountOps(key=t(np.zeros((64, 1 << 16), np.int32), device),
                               token=t(((raw - 1) % (1 << 16)).astype(np.int32), device))

    def worddoc_round(rng, device):
        uniq = ((rng.zipf(1.1, size=(64, 512 * 64)) - 1) % len(words)).astype(np.int32)
        return (t(uniq, device), t(np.full((64, 512), 64, np.int32), device),
                t(np.full(64, 512 * 64, np.int32), device))

    cases = {
        "average": (lambda dv: registry.make_dense("average", device=dv), 2, 1000, average_round, None),
        "wordcount": (lambda dv: registry.make_dense("wordcount", n_buckets=1 << 16, device=dv), 64, 1,
                      wordcount_round, None),
        "worddocumentcount": (lambda dv: registry.make_dense("worddocumentcount", n_buckets=1 << 16, device=dv),
                              64, 1, worddoc_round, "compact"),
    }
    results = {}
    gc.collect()
    for name, (make, n_rep, nk, draw, mode) in cases.items():
        runs = {}
        for device in ("cpu", dev):
            eng = make(device)
            rp = DenseReplay(eng, n_rep, n_keys=nk)
            rng = np.random.default_rng(31)
            tbl = t(table, device)
            round_ms, sync_ms = [], []
            for rnd in range(4):
                ops = draw(rng, device)
                if device != "cpu":
                    sync()
                t0 = time.perf_counter()
                if mode == "compact":
                    rp.state, _ = eng.apply_doc_ops_compact(rp.state, *ops, bucket_table=tbl)
                else:
                    rp.apply(ops)
                if device != "cpu":
                    sync()
                round_ms.append((time.perf_counter() - t0) * 1e3)
                if rnd == 1:
                    t0 = time.perf_counter()
                    rp.sync([0] + list(range(n_rep)))  # replica 0 delivered twice
                    if device != "cpu":
                        sync()
                    sync_ms.append((time.perf_counter() - t0) * 1e3)
            parts = {f"rows.{f}": v for f, v in convert.to_numpy(rp.state).items()}
            parts.update({f"base.{f}": v for f, v in convert.to_numpy(rp.base).items()})
            rp.sync()
            parts.update({f"final base.{f}": v for f, v in convert.to_numpy(rp.base).items()})
            runs[device] = (parts, round_ms, sync_ms, rp.converged())
        for label, value in runs["cpu"][0].items():
            if not np.array_equal(value, runs[dev][0][label]):
                raise AssertionError(f"{name}: CPU and card disagree on {label}")
        if not runs[dev][3]:
            raise AssertionError(f"{name}: replicas did not converge after the last sync")
        results[name] = dict(replicas=n_rep, round_ms=runs[dev][1], sync_ms=runs[dev][2], bit_identical=True)
    log("monoid", card=card, **results)

    # A delta of phase 9's coalesced round gives its state back, bit for bit.
    dense, prev, cur = topk_rmv
    sync()
    t0 = time.perf_counter()
    d = delta.make_delta(dense, prev, cur)
    back = delta.apply_any_delta(dense, prev, d)
    sync()
    delta_s = time.perf_counter() - t0
    if not all(torch.equal(x, y) for x, y in zip(leaves(back), leaves(cur))):
        raise AssertionError("apply_any_delta(prev, make_delta(prev, cur)) differs from cur")
    full_bytes = sum(x.numel() * x.element_size() for x in leaves(cur))
    del back

    # Three chained wordcount deltas coalesce to the interval's delta.
    eng = registry.make_dense("wordcount", n_buckets=1 << 16, device=dev)
    rng = np.random.default_rng(41)
    chain = [eng.init(64, 1)]
    for _ in range(3):
        chain.append(eng.apply_ops(chain[-1], wordcount_round(rng, dev))[0])
    fused = coalesce_deltas(eng, [delta.make_delta(eng, a, b) for a, b in zip(chain, chain[1:])])
    whole = delta.make_delta(eng, chain[0], chain[-1])
    if not all(torch.equal(x, y) for x, y in zip(leaves(fused), leaves(whole))):
        raise AssertionError("coalesce_deltas of 3 wordcount deltas differs from the interval's delta")
    if not all(torch.equal(x, y) for x, y in zip(leaves(delta.apply_any_delta(eng, chain[0], fused)),
                                                  leaves(chain[-1]))):
        raise AssertionError("the coalesced wordcount delta does not give the last state back")

    # The merge laws on the card, and the broken merge caught. The
    # topk_rmv fixture's kernel calls are counted (counts reset just
    # before its check) and each is held against its plain version.
    reports, law_kernels = {}, {}
    for name, fx in sorted(registry.law_fixtures().items()):
        f = fx(3, 128, device=dev)
        if name == "topk_rmv":
            for c in ("launches", "wide_launches", "block_launches", "global_launches"):
                setattr(kernels.sort_slots, c, 0)
            with held_against_plain(torch, law_kernels):
                rep = laws.check_engine_laws(f["dense"], f["states"], f["chain"])
            law_launches = kernels.sort_slots.launches
            if law_launches < 1 or not any(k.startswith("K3") for k in law_kernels):
                raise AssertionError(f"the topk_rmv law check did not launch K3: {law_launches}, {law_kernels}")
        else:
            rep = laws.check_engine_laws(f["dense"], f["states"], f["chain"])
        if not rep["ok"]:
            raise AssertionError(f"law check failed for {name}: {rep}")
        reports[name] = sorted(rep["laws"])
    f = laws.broken_merge_fixture(3, 128, device=dev)
    broken = laws.check_engine_laws(f["dense"], f["states"], f["chain"])["laws"]
    if broken["commutativity"]["ok"] or broken["associativity"]["ok"] or not broken["idempotence"]["ok"]:
        raise AssertionError(f"the broken merge was not caught as expected: {broken}")
    if len(reports) != 6:
        raise AssertionError(f"expected six law fixtures, found {sorted(reports)}")
    log("deltas and laws", card=card, topk_rmv_delta_rows=int(d.rows.numel()),
        topk_rmv_delta_bytes=delta.delta_nbytes(d), topk_rmv_state_bytes=full_bytes, delta_round_trip_s=delta_s,
        wordcount_chain_coalesced_equal=True, wordcount_delta_cells=int(whole["idx"].numel()),
        laws_ok=reports, topk_rmv_law_k3_launches=law_launches, topk_rmv_law_kernels_held=law_kernels,
        broken_merge={k: v["ok"] for k, v in broken.items()})


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    import antidote_ccrdt_tpu_torch  # noqa: F401  (fails outside the repository)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = phase_device(torch)
    phase_build()
    rows, device_jobs = phase_kernels(torch)
    launches, rp, gen = phase_main_path(torch, card)
    phase_profile(torch, rp, gen.next_batch(B, BR))
    del rp, gen
    log("device times", **{label: device_ms(torch, fn, kernel) for label, fn, kernel in device_jobs})
    del device_jobs
    phase_identity(torch)
    bm_launches, rows["sort_slots_wide"], rows["sort_slots_9_16"] = phase_batch_merge(torch, card)
    launches["sort_slots_wide"] = bm_launches["sort_slots_wide"]
    launches["sort_slots_9_16"] = bm_launches["sort_slots"]  # the converter's call, W = M = 13
    launches["sort_slots_global"], rows["sort_slots_global"] = phase_wide_rows(
        torch, card, WIDE_M, "global_launches", "sort_slots_block_kernel")
    launches["sort_slots_block"], rows["sort_slots_block"] = phase_wide_rows(
        torch, card, BLOCK_M, "block_launches", "sort_slots_block_kernel")
    topk_rmv = phase_coalesced(torch, card)
    phase_monoid(torch, card, topk_rmv)
    del topk_rmv
    sources = {
        "scatter_max_rows": ("antidote_ccrdt_tpu_torch/csrc/scatter_max_rows.cu",
                             "antidote_ccrdt_tpu/ops/pallas_kernels.py:254"),
        "scatter_max_rows_copy": ("antidote_ccrdt_tpu_torch/csrc/scatter_max_rows.cu",
                                  "antidote_ccrdt_tpu/ops/pallas_kernels.py:332"),
        "delta_place": ("antidote_ccrdt_tpu_torch/csrc/delta_place.cu",
                        "antidote_ccrdt_tpu/ops/delta_place.py:136"),
        "sort_slots": ("antidote_ccrdt_tpu_torch/csrc/sort_slots.cu",
                       "antidote_ccrdt_tpu/ops/pallas_kernels.py:150"),
        "sort_slots_9_16": ("antidote_ccrdt_tpu_torch/csrc/sort_slots.cu",
                            "antidote_ccrdt_tpu/ops/pallas_kernels.py:150"),
        "sort_slots_wide": ("antidote_ccrdt_tpu_torch/csrc/sort_slots.cu",
                            "antidote_ccrdt_tpu/ops/pallas_kernels.py:150"),
        "sort_slots_block": ("antidote_ccrdt_tpu_torch/csrc/sort_slots.cu",
                             "antidote_ccrdt_tpu/ops/pallas_kernels.py:150"),
        "sort_slots_global": ("antidote_ccrdt_tpu_torch/csrc/sort_slots.cu",
                              "antidote_ccrdt_tpu/ops/pallas_kernels.py:150"),
    }
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name], **rows[name])
        for name, (src, rep) in sources.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
