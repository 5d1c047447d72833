#!/usr/bin/env python3
"""Smoke test of the collaborative-localization main path on NVIDIA GPUs.

    python chip_smoke.py          # one card: device, kernels, session, serving
    python chip_smoke.py --four   # four cards: device, mesh

It drives the system through the entry points a user calls (ColocSession.run
and run_chunked as the CLI does, ServingEngine, parallel.mesh) at the
reference's own camera setup: 752x480 frames, an 8-level 1.2x pyramid and
5000 keypoints (BASELINE.md:17-18, coloc_node.cpp:78-84). Frames are
rendered by io/synthetic from a seed, so every pose has a ground truth.

Each phase prints one line per check, naming what was compared and the
tolerance; any failure raises and the script exits non-zero. The last line
of standard output is one JSON object naming the device JAX found. There is
no CPU fallback: without a GPU the script stops before any phase.

Precision: f32 matrix products run at "highest" everywhere
(coloc_tpu/__init__), so TF32 stays off and the geometry is held to
CPU-grade f32. The Hamming 2-NN is integer arithmetic and must agree bit
for bit with its references.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

H, W = 480, 752
LEVELS, SCALE = 8, 1.2
SESSION_KP = 5000          # the reference's maxkp
SESSION_FRAMES = 12        # per drone; frame 0 bootstraps the map
INTER_EVERY = 4            # inter-drone rounds at frames 4 and 8
SERVE_B, SERVE_KP = 8, 1024
FAST_THRESHOLD = 12        # bench.py's threshold for rendered scenes
K2NN_SHAPES = ((1024, 4096), (5000, 8192), (1024, 262144))
CENTRE_TOL, ROT_TOL_DEG = 0.05, 1.0   # tests/test_session.py:477-485
LOCALIZED_MIN = 0.9


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok: bool, phase: str, msg: str) -> None:
    log(phase, ("PASS " if ok else "FAIL ") + msg)
    if not ok:
        raise AssertionError(f"{phase}: {msg}")


def rot_deg(Ra, Rb) -> float:
    """Angle between two rotations: ||Ra - Rb||_F = 2 sqrt(2) sin(t / 2),
    which stays accurate for small angles (arccos of the trace does not)."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.degrees(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0))))


# ---------------------------------------------------------------- device
def phase_device(n_cards: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU found (JAX platform "
                 f"{devs[0].platform!r}); this script runs only on a GPU")
    if len(devs) < n_cards:
        sys.exit(f"chip_smoke: {n_cards} GPUs needed, JAX found {len(devs)}")
    from coloc_tpu import compile_cache

    cache = compile_cache.enable()
    log("device", f"device_kind={devs[0].device_kind} count={len(devs)} "
                  f"jax={jax.__version__} compile_cache={cache}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    for line in smi.splitlines():
        log("device", f"nvidia-smi: {line}")
    return devs


# --------------------------------------------------------------- kernels
def k2nn_problem(rng, Q, T):
    """Random descriptors with planted duplicates, ties and invalid rows on
    both sides."""
    td = rng.integers(0, 2 ** 32, (T, 16), dtype=np.uint64).astype(np.uint32)
    qd = rng.integers(0, 2 ** 32, (Q, 16), dtype=np.uint64).astype(np.uint32)
    n = Q // 8
    rows = rng.choice(T, size=3 * n, replace=False)
    src, dup, tie = rows[:n], rows[n:2 * n], rows[2 * n:]
    # duplicates: a bank row copied to a second row, the query equals it
    td[dup] = td[src]
    qd[:n] = td[src]
    # ties: two rows each 10 bits from the query (bits 0-9 vs 10-19)
    qd[n:2 * n] = td[tie]
    td[tie, 0] ^= np.uint32(0x3FF)
    twin = (tie + T // 2) % T
    td[twin] = qd[n:2 * n]
    td[twin, 0] ^= np.uint32(0xFFC00)
    tv = rng.random(T) > 0.05
    tv[src[: n // 4]] = False          # some planted hits are invalid
    qv = rng.random(Q) > 0.05
    return qd, td, qv, tv


def popcount_oracle(qd, td, qv, tv):
    """CUDAK2NN semantics from exact popcounts: lowest-index best, a
    duplicate of the best is the second, invalid rows count as
    _INVALID_DIST, idx = -1 without a valid row."""
    import jax
    import jax.numpy as jnp
    from coloc_tpu.ops import hamming

    inv = hamming._INVALID_DIST

    @jax.jit
    def run(qd, td, tv):
        col = jnp.arange(td.shape[0], dtype=jnp.int32)

        def one(q):
            d = jnp.where(tv, hamming.hamming_distance(q[None, :], td), inv)
            best = jnp.min(d)
            idx = jnp.argmin(d).astype(jnp.int32)
            second = jnp.min(jnp.where(col == idx, inv, d))
            return jnp.where(best < inv, idx, -1), best, second

        return jax.lax.map(one, qd, batch_size=64)

    idx, best, second = run(qd, td, tv)
    best = jnp.where(qv, best, inv)
    second = jnp.where(qv, second, inv)
    return idx, best, second


def chained_ms(fn, q, *args, samples: int = 25, chain: int = 10):
    """Median per-call time of fn(q, *args): each sample is a jitted chain
    of `chain` calls whose next query depends on every output of the
    previous call. Arrays go in as arguments, never as baked-in
    constants."""
    import jax
    import jax.numpy as jnp

    def body(_, carry):
        q, args = carry
        idx, best, second = fn(q, *args)
        bump = (jnp.sum(idx) + jnp.sum(best) + jnp.sum(second)
                < -(1 << 30)).astype(jnp.uint32)      # 0 at run time
        return q.at[0, 0].set(q[0, 0] ^ bump), args

    run = jax.jit(lambda q, *a: jax.lax.fori_loop(0, chain, body, (q, a))[0])
    run(q, *args).block_until_ready()
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        run(q, *args).block_until_ready()
        times.append((time.perf_counter() - t0) / chain)
    return statistics.median(times) * 1e3


def phase_kernels(card: str, shapes=K2NN_SHAPES, seed: int = 0):
    import jax
    import jax.numpy as jnp
    from coloc_tpu.ops import hamming

    rng = np.random.default_rng(seed)
    for Q, T in shapes:
        qd, td, qv, tv = (jnp.asarray(x) for x in k2nn_problem(rng, Q, T))
        st, pen, _ = hamming.pack_bank(td, tv)
        kern = jax.jit(lambda q, v, st, pen, T=T:
                       hamming.hamming_2nn_bank_kernel(q, v, (st, pen, T)))
        plain = jax.jit(lambda q, v, st, pen, T=T:
                        hamming.hamming_2nn_bank_plain(q, v, (st, pen, T)))
        got = kern(qd, qv, st, pen)
        for name, ref in (("plain int8 path", plain(qd, qv, st, pen)),
                          ("popcount oracle", popcount_oracle(qd, td, qv, tv))):
            same = all(np.array_equal(np.asarray(a), np.asarray(b))
                       for a, b in zip(got, ref))
            check(same, "kernels",
                  f"2-NN Q={Q} T={T}: kernel idx/best/second vs {name}, "
                  f"bit-identical (tolerance 0)")
        if (Q, T) == max(shapes, key=lambda s: s[0] * s[1]):
            mem = kern.lower(qd, qv, st, pen).compile().memory_analysis()
            log("kernels", f"memory_analysis Q={Q} T={T}: {mem}")
        t_kern = chained_ms(kern, qd, qv, st, pen)
        t_plain = chained_ms(plain, qd, qv, st, pen)
        log("kernels", f"2-NN Q={Q} T={T} on {card}: kernel {t_kern:.4f} ms, "
                       f"plain {t_plain:.4f} ms (median of 25 x 10 chained "
                       f"calls)")


# --------------------------------------------------------------- session
def render_frames(num_drones: int, num_frames: int, K, seed: int):
    from coloc_tpu.io import synthetic

    scene = synthetic.make_scene(H, W, K, seed=seed)
    frames, gt = {}, {}
    for d in range(num_drones):
        Rs, Cs = synthetic.trajectory(num_frames, d)
        frames[d] = [synthetic.render(scene, Rs[f], Cs[f])
                     for f in range(num_frames)]
        gt[d] = (Rs, Cs)
    return frames, gt


def session_config(backend: str, num_drones: int = 2, kp: int = SESSION_KP):
    from coloc_tpu.config import ColocConfig, DetectorOptions

    return ColocConfig(
        num_drones=num_drones,
        detector=DetectorOptions(
            width=W, height=H, max_keypoints=kp, num_levels=LEVELS,
            scale_factor=SCALE, fast_threshold=FAST_THRESHOLD,
            backend=backend,
        ),
        max_landmarks=8192,
    )


def pose_errors(results, gt, num_frames):
    """Per drone: rotation error (deg) and centre error of every localized
    frame against the ground truth. The session's world frame is drone 0's
    camera at frame 0; its monocular scale is fitted (one factor for all
    drones) before centres are compared."""
    R00, C00 = gt[0][0][0], gt[0][1][0]
    rot, est, ref = {}, {}, {}
    for d, res in results.items():
        Rs, Cs = gt[d]
        first = num_frames - len(res)
        rot[d], est[d], ref[d] = [], [], []
        for i, p in enumerate(res):
            if bool(p.success):
                f = first + i
                rot[d].append(rot_deg(p.pose.R, Rs[f] @ R00.T))
                est[d].append(np.asarray(p.pose.C, np.float64))
                ref[d].append(R00 @ (Cs[f] - C00))
    a = np.concatenate([np.reshape(est[d], (-1, 3)) for d in est])
    b = np.concatenate([np.reshape(ref[d], (-1, 3)) for d in ref])
    s = float((a * b).sum() / max((b * b).sum(), 1e-12))
    cen = {d: [float(np.linalg.norm(e - s * r)) for e, r in zip(est[d], ref[d])]
           for d in est}
    return {d: (rot[d], cen[d]) for d in est}, s


def phase_session(backend: str, frames, gt, K, num_frames=SESSION_FRAMES,
                  kp=SESSION_KP):
    from coloc_tpu.config import default_distortion
    from coloc_tpu.session import ColocSession

    tag = f"session/{backend}"
    cfg = session_config(backend, kp=kp)
    Ks = np.stack([K, K])
    dists = default_distortion(cfg)

    sess = ColocSession(cfg, Ks, dists)
    rounds = []
    inter_round = sess.inter_pose_round

    def counted_round(images, policy="auto"):
        out = inter_round(images, policy)
        rounds.append(out)
        return out

    sess.inter_pose_round = counted_round
    t0 = time.perf_counter()
    res = sess.run(frames, inter_every=INTER_EVERY)
    log(tag, f"run: {num_frames} frames x 2 drones in "
             f"{time.perf_counter() - t0:.1f} s wall (compile included)")

    errs, s = pose_errors(res, gt, num_frames)
    for d in (0, 1):
        ok = [bool(p.success) for p in res[d]]
        n_need = int(np.ceil(LOCALIZED_MIN * len(ok)))
        check(len(ok) > 0 and sum(ok) >= n_need, tag,
              f"drone {d}: {sum(ok)}/{len(ok)} frames after bootstrap "
              f"localized (need >= {LOCALIZED_MIN:.0%})")
        rot, cen = errs[d]
        med = float(np.median(rot)) if rot else float("inf")
        check(med < ROT_TOL_DEG, tag,
              f"drone {d}: median rotation error vs ground truth "
              f"{med:.4f} deg (< {ROT_TOL_DEG} deg)")
        log(tag, f"drone {d}: centre error vs ground truth median "
                 f"{np.median(cen):.4f}, max {np.max(cen):.4f} (session "
                 f"units; fitted scale {s:.4f} per ground-truth unit)")
    fused = [r for rnd in rounds for r in rnd.values() if r is not None]
    check(len(fused) >= 1 and all(np.isfinite(np.asarray(r.pos)).all()
                                  for r in fused), tag,
          f"inter-drone rounds: {len(rounds)} run, {len(fused)} fused "
          f"(5-point relative pose + ICI; need >= 1 with finite position)")

    chunked = ColocSession(cfg, Ks, dists)
    t0 = time.perf_counter()
    res_c = chunked.run_chunked(frames, chunk=4, inter_every=0)
    log(tag, f"run_chunked: {time.perf_counter() - t0:.1f} s wall "
             f"(compile included)")
    for d in (0, 1):
        a = [bool(p.success) for p in res[d]]
        b = [bool(p.success) for p in res_c[d]]
        check(a == b, tag, f"drone {d}: run_chunked success flags equal "
                           f"run's ({sum(b)}/{len(b)})")
        dc = [float(np.linalg.norm(np.asarray(p.pose.C) - np.asarray(q.pose.C)))
              for p, q in zip(res[d], res_c[d]) if bool(p.success)]
        dr = [rot_deg(p.pose.R, q.pose.R)
              for p, q in zip(res[d], res_c[d]) if bool(p.success)]
        check(max(dc) < CENTRE_TOL and max(dr) < ROT_TOL_DEG, tag,
              f"drone {d}: run_chunked vs run max centre diff {max(dc):.5f} "
              f"(< {CENTRE_TOL}), max rotation diff {max(dr):.5f} deg "
              f"(< {ROT_TOL_DEG})")


# --------------------------------------------------------------- serving
def serving_setup(K, B=SERVE_B, kp=SERVE_KP, seed=0):
    """B streams, each a rendered view of its own scene at a ground-truth
    pose; the map holds every stream's features at their true bearings
    (synthetic.consistent_mapdb), moved into the world frame: B*kp
    landmarks."""
    import jax.numpy as jnp
    from coloc_tpu.frontend import detect_and_describe
    from coloc_tpu.io import synthetic
    from coloc_tpu.types import MapDB

    cfg = session_config("trip", num_drones=1, kp=kp)
    rng = np.random.default_rng(seed)
    Rs, Cs = synthetic.trajectory(B, 0)
    images, Xs, descs = [], [], []
    for b in range(B):
        scene = synthetic.make_scene(H, W, K, seed=100 + b)
        img = synthetic.render(scene, Rs[b], Cs[b])
        feats = detect_and_describe(jnp.asarray(img), cfg.detector)
        m = synthetic.consistent_mapdb(feats, K, kp, rng)
        Xs.append(np.asarray(m.X) @ Rs[b] + Cs[b])      # x_cam -> world
        descs.append(np.asarray(m.desc))
        images.append(img)
    mapdb = MapDB(X=jnp.asarray(np.concatenate(Xs), jnp.float32),
                  desc=jnp.asarray(np.concatenate(descs)),
                  valid=jnp.ones(B * kp, bool))
    return cfg, np.stack(images).astype(np.float32), mapdb, (Rs, Cs)


def phase_serving(K, B=SERVE_B, kp=SERVE_KP):
    import jax
    import jax.numpy as jnp
    from coloc_tpu.frontend import detect_and_describe
    from coloc_tpu.geometry import camera as cam_ops
    from coloc_tpu.matching import match_with_map
    from coloc_tpu.serving import ServingEngine
    from coloc_tpu.sfm import localize

    cfg, images, mapdb, (Rs, Cs) = serving_setup(K, B, kp)
    cam = cam_ops.Camera(K=jnp.asarray(K), dist=jnp.zeros(3, jnp.float32))
    eng = ServingEngine(mapdb, cam, cfg)
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    pwc, _, _ = eng.localize_frames(jnp.asarray(images), key)
    jax.block_until_ready(pwc)
    log("serving", f"localize_frames B={B} against {B * kp} landmarks: "
                   f"{time.perf_counter() - t0:.1f} s wall (compile included)")
    keys = jax.random.split(key, B)      # the serve step's per-stream keys
    for b in range(B):
        f = detect_and_describe(jnp.asarray(images[b]), cfg.detector)
        m = match_with_map(f, mapdb, cfg.matcher)
        one, _ = localize.localize_image(keys[b], f, m, mapdb, cam,
                                         cfg.ransac, cfg.refiner)
        ok = bool(pwc.success[b]) and bool(one.success)
        dc = float(np.linalg.norm(np.asarray(pwc.pose.C[b])
                                  - np.asarray(one.pose.C)))
        dr = rot_deg(pwc.pose.R[b], one.pose.R)
        check(ok and dc < CENTRE_TOL and dr < ROT_TOL_DEG, "serving",
              f"stream {b}: engine vs single-stream localize_image: both "
              f"localized={ok}, centre diff {dc:.5f} (< {CENTRE_TOL}), "
              f"rotation diff {dr:.5f} deg (< {ROT_TOL_DEG}); vs ground "
              f"truth {rot_deg(pwc.pose.R[b], Rs[b]):.4f} deg, centre "
              f"{np.linalg.norm(np.asarray(pwc.pose.C[b]) - Cs[b]):.4f}")


# ------------------------------------------------------------ four cards
def phase_mesh(devs, K, bank_rows=262144):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from coloc_tpu.config import default_distortion
    from coloc_tpu.frontend import detect_and_describe_batch
    from coloc_tpu.fusion import kalman
    from coloc_tpu.geometry import camera as cam_ops
    from coloc_tpu.matching import match_with_map, pack_map_bank
    from coloc_tpu.parallel import mesh as pmesh
    from coloc_tpu.serving import ServingEngine, make_sharded_serve_step
    from coloc_tpu.session import ColocSession, _intra_all_device_step
    from coloc_tpu.types import Features, MapDB

    n = 4
    mesh = pmesh.make_mesh(devs[:n])

    def own_shards(x, what):
        shards = x.addressable_shards
        ok = (len(shards) == n
              and sorted(s.device.id for s in shards)
              == sorted(d.id for d in devs[:n])
              and all(s.data.shape[0] == x.shape[0] // n for s in shards))
        check(ok, "mesh", f"{what}: each of the {n} cards holds its own "
                          f"shard of {x.shape[0]} rows")

    # -- collaborative_step, one drone per card, vs the one-card batched
    # session step on the same inputs
    frames, _ = render_frames(2, 5, K, seed=0)
    boot_cfg = session_config("trip", num_drones=2)
    boot = ColocSession(boot_cfg, np.stack([K, K]),
                        default_distortion(boot_cfg))
    check(boot.init_map({0: frames[0][0], 1: frames[1][0]}), "mesh",
          "two-drone bootstrap map built")
    mapdb = boot.mapdb
    cfg = session_config("trip", num_drones=n)
    images = jnp.asarray(np.stack([frames[0][2], frames[1][2],
                                   frames[0][4], frames[1][4]]), jnp.float32)
    Ks = jnp.asarray(np.stack([K] * n))
    dists = jnp.zeros((n, 3), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    fb = kalman.init(n, cfg.filter)
    step = pmesh.collaborative_step(mesh, cfg)
    args = pmesh.shard_inputs(mesh, keys, images, Ks, dists, fb, mapdb)
    own_shards(args[1], "collaborative_step images")
    fb2, pos, cov, fused_pos, fused_cov, inter_ok = step(*args)
    own_shards(pos, "collaborative_step positions")
    k_loc = jnp.stack([jax.random.split(k)[0] for k in keys])

    def one_card(k, im, X, desc, valid, st, pen, Ks_, di, fx, fP, fs):
        return _intra_all_device_step(
            cfg, k, im, MapDB(X=X, desc=desc, valid=valid),
            (st, pen, X.shape[0]), Ks_, di,
            kalman.FilterBank(x=fx, P=fP, steps=fs))

    pwcs, _, filtered, *_ = jax.jit(one_card)(
        k_loc, images, mapdb.X, mapdb.desc, mapdb.valid,
        *pack_map_bank(mapdb)[:2], Ks, dists, fb.x, fb.P, fb.steps)
    dpos = np.linalg.norm(np.asarray(pos) - np.asarray(filtered.C), axis=1)
    ok = np.asarray(pwcs.success)
    check(ok.all() and float(dpos.max()) < CENTRE_TOL, "mesh",
          f"collaborative_step D={n} vs one-card batched session step: all "
          f"localized={bool(ok.all())}, max filtered-position diff "
          f"{dpos.max():.5f} (< {CENTRE_TOL})")
    check(np.isfinite(np.asarray(fused_pos)).all(), "mesh",
          f"ring inter-drone fusion finite, inter_ok="
          f"{np.asarray(inter_ok).tolist()}")

    # -- sharded_map_match over a 262144-landmark bank
    rng = np.random.default_rng(2)
    qd, td, qv, tv = (jnp.asarray(x)
                      for x in k2nn_problem(rng, 1024, bank_rows))
    sm = pmesh.sharded_map_match(mesh, cfg.matcher)
    bsh = NamedSharding(mesh, P(pmesh.DRONE_AXIS))
    td_s, tv_s = jax.device_put(td, bsh), jax.device_put(tv, bsh)
    own_shards(td_s, "sharded_map_match bank")
    got = sm(qd, qv, td_s, tv_s)
    feats = Features(xy=jnp.zeros((1024, 2)), score=jnp.ones(1024),
                     scale=jnp.zeros(1024, jnp.int32), angle=jnp.zeros(1024),
                     desc=qd, valid=qv)
    ref = match_with_map(feats, MapDB(X=jnp.zeros((bank_rows, 3)), desc=td,
                                      valid=tv), cfg.matcher)
    same = all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(got, ref))
    check(same, "mesh", f"sharded_map_match {n} x {bank_rows // n} vs "
                        f"one-card 2-NN over {bank_rows}: idx/best/second "
                        f"bit-identical (tolerance 0)")

    # -- sharded serving, 4 x 8 streams, vs the one-card ServingEngine:
    # every card serves the same 8 streams; card i's per-stream keys are
    # split(fold_in(key, i), 8), which the one-card engine reproduces when
    # handed fold_in(key, i)
    scfg, simgs, smap, _ = serving_setup(K)
    b_local = simgs.shape[0]
    feats8 = jax.jit(lambda x: detect_and_describe_batch(x, scfg.detector))(
        jnp.asarray(simgs))
    feats_b = jax.tree.map(lambda x: jnp.concatenate([x] * n), feats8)
    B = n * b_local
    cams = cam_ops.Camera(K=jnp.broadcast_to(jnp.asarray(K), (B, 3, 3)),
                          dist=jnp.zeros((B, 3), jnp.float32))
    st, pe, _ = pack_map_bank(smap)
    run = make_sharded_serve_step(mesh, scfg)
    key = jax.random.PRNGKey(3)
    fsh = jax.tree.map(lambda x: jax.device_put(x, bsh), feats_b)
    own_shards(fsh.desc, "sharded serving features")
    pw, _, _ = run(key, fsh, jax.tree.map(lambda x: jax.device_put(x, bsh),
                                          cams), smap, st, pe)
    own_shards(pw.pose.C, "sharded serving poses")
    eng = ServingEngine(smap, cam_ops.Camera(K=jnp.asarray(K),
                                             dist=jnp.zeros(3, jnp.float32)),
                        scfg)
    ones = [eng.localize_frames(jnp.asarray(simgs),
                                jax.random.fold_in(key, i))[0]
            for i in range(n)]
    oneC = np.concatenate([np.asarray(o.pose.C) for o in ones])
    oneR = np.concatenate([np.asarray(o.pose.R) for o in ones])
    ok = np.asarray(pw.success) & np.concatenate(
        [np.asarray(o.success) for o in ones])
    dc = np.linalg.norm(np.asarray(pw.pose.C) - oneC, axis=1)
    dr = [rot_deg(pw.pose.R[b], oneR[b]) for b in range(B)]
    check(ok.all() and dc.max() < CENTRE_TOL and max(dr) < ROT_TOL_DEG,
          "mesh", f"make_sharded_serve_step {n} x {b_local} streams vs "
                  f"one-card ServingEngine: all localized={bool(ok.all())}, "
                  f"max centre diff {dc.max():.5f} (< {CENTRE_TOL}), max "
                  f"rotation diff {max(dr):.5f} deg (< {ROT_TOL_DEG})")


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card mesh phase only")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "coloc_tpu")):
        sys.exit("chip_smoke: the coloc_tpu package is not beside this "
                 "script; run it from a checkout of the repository")
    sys.path.insert(0, here)

    n_cards = 4 if args.four else 1
    devs = phase_device(n_cards)
    card = devs[0].device_kind
    from coloc_tpu.config import ColocConfig, default_intrinsics

    K = default_intrinsics(ColocConfig(num_drones=1))[0]   # EuRoC cam0
    t0 = time.perf_counter()
    if args.four:
        phase_mesh(devs, K)
    else:
        phase_kernels(card, seed=args.seed)
        frames, gt = render_frames(2, SESSION_FRAMES, K, seed=args.seed)
        for backend in ("trip", "akaze"):
            phase_session(backend, frames, gt, K)
        phase_serving(K)
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": card, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
