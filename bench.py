"""Benchmark: frame-pairs matched+localized per second per device.

Measures the metric from BASELINE.json: one "op" = full frame processing —
detect+describe a frame, 2-NN Hamming match against the resident map bank,
P3P RANSAC + pose refinement. Timing uses feedback chaining (each
iteration's input depends on the previous output), so no iteration can be
hoisted or deduplicated.

Prints ONE JSON line: {"metric", "value", "unit", "p50_ms", "p99_ms"}, then
context lines on stderr.

Env knobs: COLOC_BENCH_SMALL=1 for a tiny CPU-friendly config;
COLOC_BENCH_ITERS to override the timing loop length.
"""

import json
import os
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    # persistent compile cache (same default as cli.py/serve.py;
    # COLOC_COMPILE_CACHE=0 opts out): the bench's many jit graphs compile
    # once per machine, not once per run — 'compile=' lines report the warm
    # cost on a cache hit
    from coloc_tpu import compile_cache

    compile_cache.enable()

    small = os.environ.get("COLOC_BENCH_SMALL", "0") == "1"
    # long chained loops amortize the fixed per-dispatch cost
    iters = int(os.environ.get("COLOC_BENCH_ITERS", "4" if small else "500"))

    from coloc_tpu.config import ColocConfig, DetectorOptions, MatcherOptions
    from coloc_tpu.frontend import detect_and_describe
    from coloc_tpu.geometry import camera as cam_ops
    from coloc_tpu.io import synthetic
    from coloc_tpu.matching import match_with_map
    from coloc_tpu.sfm import localize

    if small:
        h, w, kp, landmarks, levels = 96, 128, 128, 256, 2
    else:
        # reference workload: 752x480 frames, 8-level 1.2x pyramid
        # (coloc_node.cpp:73-85), map bank at full maxkp-class capacity
        h, w, kp, landmarks, levels = 480, 752, 1024, 4096, 8

    config = ColocConfig(
        detector=DetectorOptions(
            width=w, height=h, max_keypoints=kp, num_levels=levels,
            fast_threshold=12,
        ),
        matcher=MatcherOptions(),
        max_landmarks=landmarks,
    )

    K = np.array(
        [[0.6 * w, 0, w / 2], [0, 0.6 * w, h / 2], [0, 0, 1]], np.float32
    )
    cam = cam_ops.Camera(K=jnp.asarray(K), dist=jnp.zeros(3, jnp.float32))

    # realistic frame + map: rendered synthetic scene, map built from
    # detected features at ground-truth-triangulated positions
    scene = synthetic.make_scene(h, w, K, seed=1)
    img = jnp.asarray(synthetic.render(scene, np.eye(3, dtype=np.float32),
                                       np.zeros(3, np.float32)))

    feats0 = detect_and_describe(img, config.detector)
    rng = np.random.default_rng(0)
    # geometrically CONSISTENT map (synthetic.consistent_mapdb): landmarks
    # on the frame's feature bearings, so P3P + refinement run their honest
    # convergent path
    mapdb = synthetic.consistent_mapdb(feats0, K, landmarks, rng)

    # ---- headline: the north-star op (BASELINE.json metric "frame-pair
    # match+localize ops/sec/chip") = the reference's per-frame hot path
    # (SURVEY §3.5 intraPoseEstimator): Hamming 2-NN against the RESIDENT map
    # bank (setMapData pattern) + P3P RANSAC + pose refinement. Detection/
    # description is the separate BASELINE config 1, reported below and in
    # the full-pipeline stderr line.
    from coloc_tpu.matching import pack_map_bank

    bank = pack_map_bank(mapdb)

    def match_localize_op(key, feats):
        mm = match_with_map(feats, mapdb, config.matcher, bank=bank)
        pwc, _ = localize.localize_image(
            key, feats, mm, mapdb, cam, config.ransac, config.refiner
        )
        return pwc

    @jax.jit
    def loop(key, desc0):
        def body(i, carry):
            k, desc = carry
            k1, k2 = jax.random.split(k)
            pwc = match_localize_op(k1, feats0._replace(desc=desc))
            # feedback THROUGH THE MATCHER: xor the descriptors with a
            # data-dependent runtime-zero so the match stage cannot be
            # hoisted out of the loop (it reads desc, which depends on the
            # previous iteration's pose)
            zero = jnp.where(pwc.pose.C[0] < 1e30, 0, 1).astype(jnp.uint32)
            return (k2, feats0.desc ^ zero)
        return jax.lax.fori_loop(0, iters, body, (key, desc0))

    def full_frame_op(key, image):
        feats = detect_and_describe(image, config.detector)
        mm = match_with_map(feats, mapdb, config.matcher, bank=bank)
        pwc, _ = localize.localize_image(
            key, feats, mm, mapdb, cam, config.ransac, config.refiner
        )
        return pwc

    @jax.jit
    def loop_full(key, image):
        def body(i, carry):
            k, img_c = carry
            k1, k2 = jax.random.split(k)
            pwc = full_frame_op(k1, img_c)
            img_next = image + pwc.rmse * 1e-7 + pwc.pose.C[0] * 1e-9
            return (k2, img_next)
        return jax.lax.fori_loop(0, iters, body, (key, image))

    # chunked variant of the SAME chained headline loop for latency
    # percentiles: C ops per dispatch, carry fed back across dispatches so
    # no call can be deduped/hoisted; each dispatch's wall time / C is one
    # per-op latency sample (BASELINE metric "p50 per-frame pose latency")
    chunk = max(1, min(25, iters))

    @jax.jit
    def loop_chunk(key, desc0):
        def body(i, carry):
            k, desc = carry
            k1, k2 = jax.random.split(k)
            pwc = match_localize_op(k1, feats0._replace(desc=desc))
            zero = jnp.where(pwc.pose.C[0] < 1e30, 0, 1).astype(jnp.uint32)
            return (k2, feats0.desc ^ zero)
        return jax.lax.fori_loop(0, chunk, body, (key, desc0))

    key = jax.random.PRNGKey(0)
    t0 = time.time()
    out = jax.block_until_ready(loop(key, feats0.desc))
    out2 = jax.block_until_ready(loop_full(key, img))
    compile_s = time.time() - t0

    t0 = time.time()
    out = jax.block_until_ready(loop(key, feats0.desc))
    dt = (time.time() - t0) / iters

    t0 = time.time()
    out2 = jax.block_until_ready(loop_full(key, img))
    dt_full = (time.time() - t0) / iters

    # per-op latency distribution over chained chunks
    n_chunks = max(8, iters // chunk)
    carry = jax.block_until_ready(loop_chunk(key, feats0.desc))  # warm
    samples = []
    for _ in range(n_chunks):
        t0 = time.time()
        carry = jax.block_until_ready(loop_chunk(*carry))
        samples.append((time.time() - t0) / chunk)
    lat = np.sort(np.asarray(samples)) * 1e3  # ms per op
    p50 = float(np.percentile(lat, 50))
    p99 = float(np.percentile(lat, 99))

    ops_per_sec = 1.0 / dt
    result = {
        "metric": "frame-pair match+localize ops/sec/chip",
        "value": round(ops_per_sec, 2),
        "unit": "ops/s",
        "p50_ms": round(p50, 4),
        "p99_ms": round(p99, 4),
    }
    print(json.dumps(result))
    # extra context on stderr (driver reads only the stdout JSON line)
    import sys

    print(
        f"# backend={jax.default_backend()} config={w}x{h} kp={kp} "
        f"map={landmarks} iters={iters} compile={compile_s:.1f}s "
        f"match+localize={dt * 1e3:.2f}ms "
        f"full-pipeline(+detect/describe)={dt_full * 1e3:.2f}ms "
        f"({1 / dt_full:.1f} ops/s)",
        file=sys.stderr,
    )
    print(
        f"# latency headline (per-op over {n_chunks} chained chunks of "
        f"{chunk}): p50={p50:.3f}ms p99={p99:.3f}ms "
        f"(chunk dispatch cost amortized /{chunk})",
        file=sys.stderr,
    )

    if not small and os.environ.get("COLOC_BENCH_CAPACITY", "1") == "1":
        _bench_capacity(cam, img, iters)
    if not small and os.environ.get("COLOC_BENCH_MAPSCALE", "1") == "1":
        _bench_map_scaling(config, cam, feats0, iters)
    if not small and os.environ.get("COLOC_BENCH_BATCHED", "1") == "1":
        _bench_batched_serving(config, cam, mapdb, feats0, iters)
    if not small and os.environ.get("COLOC_BENCH_AKAZE", "1") == "1":
        _bench_akaze(scene, img, cam, iters)
    config_akaze = ColocConfig(
        detector=DetectorOptions(
            width=w, height=h, max_keypoints=kp, num_levels=levels,
            backend="akaze",
        ),
        matcher=MatcherOptions(mode="ratio"),
        max_landmarks=landmarks,
    )
    if not small and os.environ.get("COLOC_BENCH_SESSION", "1") == "1":
        _bench_chained_session(config, cam, iters)
    if not small and os.environ.get("COLOC_BENCH_AKAZE_SESSION", "1") == "1":
        # the same chained 2-drone session with the reference's DEFAULT
        # (CPU/AKAZE) detector configuration
        _bench_chained_session(config_akaze, cam, iters, label="akaze ")
    if not small and os.environ.get("COLOC_BENCH_DSCALE", "1") == "1":
        # D-scaling: the all-drones batched session step
        # at D=4 and D=8 on ONE chip, both backends — substantiates the
        # "one kernel per stage for all drones" batching claim
        # (session.py:55-58) against the reference's sequential drone loop
        # (coloc.hpp:128-148). Compile time and ms/drone are in each line.
        import dataclasses as dc

        for D in (4, 8):
            _bench_chained_session(
                dc.replace(config, num_drones=D), cam, iters,
                heading="D-scaling[trip chained session",
            )
        for D in (4, 8):
            _bench_chained_session(
                dc.replace(config_akaze, num_drones=D), cam,
                max(64, iters // 4),
                heading="D-scaling[akaze chained session",
            )
    if os.environ.get("COLOC_BENCH_CONFIGS", "0") == "1":
        _bench_baseline_configs(config, cam, mapdb, img, feats0, iters)
    if os.environ.get("COLOC_BENCH_ACCURACY", "0") == "1":
        _bench_accuracy(config, cam, scene, K)
    if not small and (os.environ.get("COLOC_EUROC_ROOT")
                      or os.environ.get("COLOC_KITTI_ROOT")):
        _bench_real_data()


def _bench_real_data():
    """Real-dataset ATE/RPE report, auto-run whenever COLOC_EUROC_ROOT /
    COLOC_KITTI_ROOT points at a real sequence (skipped otherwise). Runs
    the full CLI runpath in this process (a second JAX process would need
    its own share of the device) and relays the accuracy lines to
    stderr."""
    import contextlib
    import io
    import sys
    import tempfile

    from coloc_tpu import cli

    jobs = []
    if os.environ.get("COLOC_EUROC_ROOT"):
        jobs.append(("euroc", "--euroc", os.environ["COLOC_EUROC_ROOT"]))
    if os.environ.get("COLOC_KITTI_ROOT"):
        jobs.append(("kitti", "--kitti", os.environ["COLOC_KITTI_ROOT"]))
    n = os.environ.get("COLOC_REAL_DATA_FRAMES", "100")
    for name, flag, root in jobs:
        out = io.StringIO()
        try:
            with tempfile.TemporaryDirectory() as td, \
                    contextlib.redirect_stdout(out):
                cli.main([flag, root, "--frames", n, "--out", td])
        except Exception as e:   # one bad dataset must not kill the bench
            print(f"# {name} real-data FAILED: {e!r}", file=sys.stderr)
        for line in out.getvalue().splitlines():
            if "ATE=" in line or "localized" in line:
                print(f"# {name} real-data: {line}", file=sys.stderr)


def _bench_capacity(cam, img, iters):
    """Reference-capacity demonstration (coloc_node.cpp:78: maxkp=5000):
    match+localize headline at kp=5000 against an 8192-landmark map, plus the
    raw 2-NN kernel's measured comparison rate vs CUDAK2NN's published
    63 G cmp/s on a GTX 1080 (src/CUDAK2NN.cu:23-25). Stderr only."""
    import sys
    import time

    import jax
    import jax.numpy as jnp

    from coloc_tpu.config import ColocConfig, DetectorOptions, MatcherOptions
    from coloc_tpu.frontend import detect_and_describe
    from coloc_tpu.matching import match_with_map, pack_map_bank
    from coloc_tpu.ops import hamming
    from coloc_tpu.sfm import localize

    kp, landmarks = 5000, 8192
    h, w = img.shape
    config = ColocConfig(
        detector=DetectorOptions(width=w, height=h, max_keypoints=kp,
                                 num_levels=8, fast_threshold=12),
        matcher=MatcherOptions(),
        max_landmarks=landmarks,
    )
    feats = detect_and_describe(img, config.detector)
    rng = np.random.default_rng(1)
    from coloc_tpu.io import synthetic as synth

    mapdb = synth.consistent_mapdb(feats, np.asarray(cam.K), landmarks, rng)
    bank = pack_map_bank(mapdb)
    key = jax.random.PRNGKey(0)

    @jax.jit
    def loop(key, desc0):
        def body(i, carry):
            k, desc = carry
            k1, k2 = jax.random.split(k)
            f = feats._replace(desc=desc)
            mm = match_with_map(f, mapdb, config.matcher, bank=bank)
            pwc, _ = localize.localize_image(
                k1, f, mm, mapdb, cam, config.ransac, config.refiner
            )
            zero = jnp.where(pwc.pose.C[0] < 1e30, 0, 1).astype(jnp.uint32)
            return (k2, feats.desc ^ zero)
        return jax.lax.fori_loop(0, iters, body, (key, desc0))

    jax.block_until_ready(loop(key, feats.desc))
    t0 = time.time()
    jax.block_until_ready(loop(key, feats.desc))
    dt = (time.time() - t0) / iters

    # raw 2-NN comparison rate at capacity (array-carried feedback: the
    # next queries depend on every output, so nothing is hoistable)
    @jax.jit
    def kloop(d0, qv):
        def body(i, d):
            idx, best, second = hamming.hamming_2nn_bank(d, qv, bank)
            bump = (jnp.sum(idx) + jnp.sum(best) + jnp.sum(second)
                    < -(1 << 30)).astype(jnp.uint32)
            return d.at[0, 0].set(d[0, 0] ^ bump)
        return jax.lax.fori_loop(0, iters, body, d0)

    jax.block_until_ready(kloop(feats.desc, feats.valid))
    t0 = time.time()
    jax.block_until_ready(kloop(feats.desc, feats.valid))
    kdt = (time.time() - t0) / iters
    gcmp = feats.desc.shape[0] * landmarks / kdt / 1e9

    print(
        f"# capacity kp={kp} map={landmarks}: "
        f"match+localize={dt * 1e3:.2f}ms ({1 / dt:.1f} ops/s); "
        f"2-NN {gcmp:.0f} G cmp/s "
        f"(CUDAK2NN GTX1080: 63 G cmp/s)",
        file=sys.stderr,
    )


def _bench_map_scaling(config, cam, feats0, iters):
    """Map-growth headroom: the headline match+localize op against landmark
    banks far beyond the reference's 5000-descriptor cap (SURVEY §5
    'long-context analog': the reference REPLACES its map wholesale because
    brute-force matching is O(map); here the device-resident bank + int8
    2-NN keep growing maps on ONE device — and mesh.sharded_map_match shards
    the bank across devices past that). Stderr only."""
    import sys
    import time

    import jax
    import jax.numpy as jnp

    from coloc_tpu.matching import match_with_map, pack_map_bank
    from coloc_tpu.sfm import localize

    kp = feats0.xy.shape[0]
    rng = np.random.default_rng(3)
    from coloc_tpu.io import synthetic as synth

    key = jax.random.PRNGKey(0)
    lines = []
    for landmarks, twostage in ((16384, False), (65536, False),
                                (262144, False), (262144, True)):
        mapdb = synth.consistent_mapdb(
            feats0, np.asarray(cam.K), landmarks, rng
        )
        if twostage:
            from coloc_tpu.matching import pack_map_bank_twostage

            ts_bank = pack_map_bank_twostage(mapdb)
            bank = None
        else:
            bank = pack_map_bank(mapdb)
            ts_bank = None

        @jax.jit
        def loop(key, desc0, mapdb=mapdb, bank=bank, ts_bank=ts_bank):
            def body(i, carry):
                k, desc = carry
                k1, k2 = jax.random.split(k)
                f = feats0._replace(desc=desc)
                mm = match_with_map(f, mapdb, config.matcher, bank=bank,
                                    twostage_bank=ts_bank)
                pwc, _ = localize.localize_image(
                    k1, f, mm, mapdb, cam, config.ransac, config.refiner
                )
                zero = jnp.where(pwc.pose.C[0] < 1e30, 0, 1).astype(jnp.uint32)
                return (k2, feats0.desc ^ zero)
            return jax.lax.fori_loop(0, iters, body, (key, desc0))

        jax.block_until_ready(loop(key, feats0.desc))
        t0 = time.time()
        jax.block_until_ready(loop(key, feats0.desc))
        dt = (time.time() - t0) / iters
        tag = " two-stage" if twostage else ""
        lines.append(
            f"map={landmarks}{tag}: {dt * 1e3:.2f}ms ({1 / dt:.1f} ops/s)")
    print(
        f"# map scaling kp={kp} (reference map cap: 5000): "
        + "; ".join(lines), file=sys.stderr,
    )


def _bench_batched_serving(config, cam, mapdb, feats0, iters):
    """Production-serving throughput: B independent frame streams
    matched+localized in ONE dispatch per step (serving.make_serve_step —
    the public ServingEngine step). The single-stream headline leaves the
    chip underfilled — its P3P RANSAC + refine stages run tiny
    per-hypothesis matrices; batching B streams shares the 2-NN kernel
    over B*kp concatenated queries and vmaps localization, so one chip
    serves B robot streams per dispatch.
    Stderr only; the stdout headline stays single-stream."""
    import sys
    import time

    import jax
    import jax.numpy as jnp

    from coloc_tpu import serving
    from coloc_tpu.matching import pack_map_bank

    bank = pack_map_bank(mapdb)
    kp = feats0.xy.shape[0]
    key = jax.random.PRNGKey(0)
    lines = []
    sizes = tuple(int(b) for b in os.environ.get(
        "COLOC_BENCH_BATCH_SIZES", "8,16,32,64").split(","))
    step = serving.make_serve_step(config, cam)
    for B in sizes:

        @jax.jit
        def loop(key, desc0, B=B):
            desc_b = jnp.broadcast_to(desc0, (B,) + desc0.shape)

            def body(i, carry):
                k, db = carry
                k1, k2 = jax.random.split(k)
                feats_b = jax.tree.map(
                    lambda x: jnp.broadcast_to(x, (B,) + x.shape), feats0
                )._replace(desc=db)
                pwcs, _, _ = step(k1, feats_b, mapdb, bank)
                # per-stream runtime-zero feedback through the matcher so no
                # stream's match+localize chain can be hoisted or deduped
                zeros = jnp.where(pwcs.pose.C[:, 0] < 1e30, 0, 1).astype(
                    jnp.uint32)
                return (k2, desc_b ^ zeros[:, None, None])
            return jax.lax.fori_loop(0, iters, body, (key, desc_b))

        jax.block_until_ready(loop(key, feats0.desc))
        t0 = time.time()
        jax.block_until_ready(loop(key, feats0.desc))
        dt = (time.time() - t0) / iters
        lines.append(
            f"B={B}: {dt * 1e3:.2f}ms/step = {B / dt:.0f} ops/s"
        )
    print(
        f"# batched serving (kp={kp}, map={mapdb.X.shape[0]}, "
        f"match+localize per stream): " + "; ".join(lines),
        file=sys.stderr,
    )

    # per-DISPATCH latency percentiles at one representative batch: each
    # sample is a full single-step round trip (what a serving client sees,
    # including dispatch overhead). The desc carry feeds each dispatch from the previous one's output so
    # dispatches cannot be deduped or pipelined past each other.
    Bp = 16

    @jax.jit
    def one_step(key, desc_b):
        k1, k2 = jax.random.split(key)
        feats_b = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (Bp,) + x.shape), feats0
        )._replace(desc=desc_b)
        pwcs, _, _ = step(k1, feats_b, mapdb, bank)
        zeros = jnp.where(pwcs.pose.C[:, 0] < 1e30, 0, 1).astype(jnp.uint32)
        desc_next = (jnp.broadcast_to(feats0.desc, desc_b.shape)
                     ^ zeros[:, None, None])
        return k2, desc_next, pwcs.success

    desc_b0 = jnp.broadcast_to(
        feats0.desc, (Bp,) + feats0.desc.shape).copy()
    k = key
    k, desc_b, _ = one_step(k, desc_b0)
    jax.block_until_ready(desc_b)  # warm
    n_disp = int(os.environ.get("COLOC_BENCH_DISPATCHES", "100"))
    samples = []
    for _ in range(n_disp):
        t0 = time.time()
        k, desc_b, succ = one_step(k, desc_b)
        jax.block_until_ready(succ)
        samples.append(time.time() - t0)
    lat = np.sort(np.asarray(samples)) * 1e3
    print(
        f"# serving per-dispatch latency B={Bp} ({n_disp} dispatches, "
        f"blocking each): p50={np.percentile(lat, 50):.2f}ms "
        f"p99={np.percentile(lat, 99):.2f}ms "
        f"(includes host dispatch)",
        file=sys.stderr,
    )


def _bench_chained_session(config, cam, iters, label="", heading=None):
    """BASELINE config 5 as a DEVICE-RESIDENT number: a real D-drone session
    (bootstrap map from rendered frames, then the steady-state loop) stepped
    in lax.scan chunks with the KF bank carried on device
    (session.intra_pose_chunk). One dispatch per F-frame chunk, so the
    per-dispatch cost amortizes over F*D ops. D comes from
    config.num_drones (the batched drone axis: one kernel per stage for ALL
    drones, session.py). Stderr only."""
    import sys
    import time

    import jax
    import numpy as np

    from coloc_tpu.io import synthetic
    from coloc_tpu.session import ColocSession

    D = config.num_drones
    h = int(2 * float(cam.cy))
    w = int(2 * float(cam.cx))
    Kmat = np.asarray(cam.K)
    scn = synthetic.make_scene(h, w, Kmat, seed=2)
    frames = {}
    for d in range(D):
        Rs, Cs = synthetic.trajectory(4, d)
        frames[d] = [synthetic.render(scn, Rs[f], Cs[f]) for f in range(4)]
    sess = ColocSession(config, np.stack([Kmat] * D),
                        np.zeros((D, 3), np.float32))
    if D <= 2:
        boot = sess.init_map({d: frames[d][0] for d in range(D)})
    else:
        # D-scaling sections measure the STEADY-STATE batched step, not
        # bootstrap quality: share the 2-drone two-view bootstrap map across
        # the fleet (drones 2..D-1 follow parallel offset trajectories over
        # the same scene, so the map covers their views too)
        import dataclasses as dc

        cfg2 = dc.replace(config, num_drones=2)
        sess2 = ColocSession(cfg2, np.stack([Kmat] * 2),
                             np.zeros((2, 3), np.float32))
        boot = sess2.init_map({0: frames[0][0], 1: frames[1][0]})
        if boot:
            sess.scene = sess2.scene
            sess.mapdb = sess2.mapdb
            sess.map_ready = True
    if not boot:
        print(f"# config[5b {label}chained session]: bootstrap failed",
              file=sys.stderr)
        return
    import jax.numpy as jnp

    F = 16
    # pre-stage the chunk on the device ONCE: passing a host numpy block
    # would re-upload ~46 MB per call
    block = jnp.asarray(np.stack(
        [[frames[d][1 + (i % 3)] for d in range(D)] for i in range(F)]
    ))
    block.block_until_ready()
    sess.frame = 1

    # Time the chained step function itself with the KF carry fed back on
    # device: ONE dispatch per F-frame chunk and no per-frame result
    # materialization. (Session-level intra_pose_chunk builds per-frame
    # PoseWithCov views — ~100 tiny device slices per chunk — which this
    # number leaves out.)
    chain = sess._fused_intra_scan()
    bank_st, bank_pen, _ = sess._map_bank()
    reps = max(2, iters // (F * D))
    keys = jax.random.split(jax.random.PRNGKey(0), reps * F * D).reshape(
        reps, F, D, -1
    )
    mdb = sess.mapdb
    sess._ensure_support()
    state = (sess.filter_bank.x, sess.filter_bank.P, sess.filter_bank.steps,
             sess.lm_support, sess.lm_last_seen, jnp.int32(sess.frame))
    t0 = time.time()
    carry, outs = chain(keys[0], block, mdb.X, mdb.desc, mdb.valid, bank_st,
                        bank_pen, sess.Ks, sess.dists, *state)
    jax.block_until_ready(carry)
    compile_s = time.time() - t0
    # health: how many drones localized on the final scanned frame
    n_ok = int(np.asarray(outs[0].success)[-1].sum())
    t0 = time.time()
    state = carry
    for r in range(reps):
        state, _ = chain(keys[r], block, mdb.X, mdb.desc, mdb.valid,
                         bank_st, bank_pen, sess.Ks, sess.dists, *state)
    jax.block_until_ready(state)
    dt = (time.time() - t0) / (reps * F * D)
    print(
        f"# {heading or f'config[5b {label}chained session'}"
        f", lax.scan x{F} frames, D={D} batched drone axis, device-resident"
        f" KF carry]: {dt * 1e3:.2f} ms/op = {1 / dt:.1f} ops/s "
        f"(= {dt * D * 1e3:.2f} ms/frame-step for all {D} drones; "
        f"chain compile+warm {compile_s:.1f}s; "
        f"{reps} chunks; {n_ok}/{D} drones localized on the final frame)",
        file=sys.stderr,
    )


def _bench_akaze(scene, img, cam, iters):
    """AKAZE-MLDB parity backend at the reference's CPU-default preset
    (752x480 frame, maxkp=5000, CPUDetector.hpp:35-46 / coloc_node.cpp:78):
    detect+describe latency, the FULL pipeline (detect -> Lowe-0.8 2-NN vs
    the resident map bank -> P3P RANSAC + refine — intraPoseEstimator with
    the reference's default detector, SURVEY §3.5), and a downstream
    two-view match count. Stderr only."""
    import sys
    import time

    import jax
    import jax.numpy as jnp

    from coloc_tpu.config import ColocConfig, DetectorOptions, MatcherOptions
    from coloc_tpu.frontend import detect_and_describe
    from coloc_tpu.io import synthetic
    from coloc_tpu.matching import match_pair, match_with_map, pack_map_bank
    from coloc_tpu.sfm import localize

    h, w = img.shape
    kp = 5000
    config = ColocConfig(
        detector=DetectorOptions(
            width=w, height=h, max_keypoints=kp, num_levels=8,
            backend="akaze",
        ),
        # AKAZE path = reference CPU path = Lowe-ratio matching (OpenMVG
        # DistanceRatioMatch 0.8, CPUMatcher.hpp:58-59)
        matcher=MatcherOptions(mode="ratio"),
        max_landmarks=8192,
    )
    jimg = jnp.asarray(img)
    it = max(4, min(iters, 100))  # AKAZE's FED pipeline is ~10x the TRIP
    # frontend; 100 chained iterations keep this section under ~30 s

    @jax.jit
    def loop(x):
        def body(i, c):
            f = detect_and_describe(c, config.detector)
            # consume desc + xy + score so XLA cannot dead-code-eliminate the
            # MLDB describe stage (an earlier body used only f.score and
            # silently timed detection alone)
            live = (f.score.sum() + f.xy.sum()
                    + f.desc.astype(jnp.float32).sum())
            return jimg + live * 1e-12
        return jax.lax.fori_loop(0, it, body, x)

    jax.block_until_ready(loop(jimg))
    t0 = time.time()
    jax.block_until_ready(loop(jimg))
    dt = (time.time() - t0) / it

    # downstream health at capacity: second rendered view, pairwise ratio
    # match + count (exercises the grid-based cross-scale suppression at
    # reference capacity — see coloc_tpu/akaze.py)
    from coloc_tpu.geometry import so3 as _so3

    R2 = np.asarray(_so3.exp(jnp.asarray([0.01, -0.05, 0.0], jnp.float32)))
    C2 = np.array([0.4, 0.05, 0.0], np.float32)
    img2 = jnp.asarray(synthetic.render(scene, R2, C2))
    fa = detect_and_describe(jimg, config.detector)
    fb = detect_and_describe(img2, config.detector)
    m = match_pair(fa, fb, config.matcher)
    n_kp = int(jnp.sum(fa.valid))
    n_match = int(jnp.sum(m.idx >= 0))
    print(
        f"# akaze kp={kp} {w}x{h}: detect+describe={dt * 1e3:.2f}ms "
        f"({1 / dt:.1f} fps); detected={n_kp} "
        f"pair-matches={n_match}",
        file=sys.stderr,
    )

    # ---- full pipeline with the AKAZE backend: detect -> ratio 2-NN vs
    # the RESIDENT map bank -> P3P RANSAC + refine, chained (same loop
    # structure as the TRIP headline full-pipeline line in main())
    rng = np.random.default_rng(2)
    L = config.max_landmarks
    mapdb = synthetic.consistent_mapdb(fa, np.asarray(cam.K), L, rng)
    bank = pack_map_bank(mapdb)

    @jax.jit
    def loop_full(key, image):
        def body(i, carry):
            k, img_c = carry
            k1, k2 = jax.random.split(k)
            f = detect_and_describe(img_c, config.detector)
            mm = match_with_map(f, mapdb, config.matcher, bank=bank)
            pwc, _ = localize.localize_image(
                k1, f, mm, mapdb, cam, config.ransac, config.refiner
            )
            img_next = image + pwc.rmse * 1e-7 + pwc.pose.C[0] * 1e-9
            return (k2, img_next)
        return jax.lax.fori_loop(0, it, body, (key, image))

    key = jax.random.PRNGKey(0)
    jax.block_until_ready(loop_full(key, jimg))
    t0 = time.time()
    jax.block_until_ready(loop_full(key, jimg))
    dt_full = (time.time() - t0) / it

    # health check outside the loop: does the pipeline actually localize?
    mm1 = match_with_map(fa, mapdb, config.matcher, bank=bank)
    pwc1, _ = localize.localize_image(
        jax.random.PRNGKey(1), fa, mm1, mapdb, cam, config.ransac,
        config.refiner,
    )
    print(
        f"# akaze full-pipeline kp={kp} map={L}: {dt_full * 1e3:.2f}ms "
        f"({1 / dt_full:.1f} ops/s); localize success={bool(pwc1.success)} "
        f"inliers={int(pwc1.n_tracks)}",
        file=sys.stderr,
    )

    # akaze frontier: a fast preset (3 octaves, 3 sublevels, 3x3 MLDB cell
    # samples) at kp=1024 beside the reference NORMAL preset above
    fast_opts = DetectorOptions(
        width=w, height=h, max_keypoints=1024, num_levels=6,
        backend="akaze", akaze_sublevels=3, akaze_cell_samples=3,
    )

    @jax.jit
    def loop_fast(x):
        def body(i, c):
            f = detect_and_describe(c, fast_opts)
            live = (f.score.sum() + f.xy.sum()
                    + f.desc.astype(jnp.float32).sum())
            return jimg + live * 1e-12
        return jax.lax.fori_loop(0, it, body, x)

    jax.block_until_ready(loop_fast(jimg))
    t0 = time.time()
    jax.block_until_ready(loop_fast(jimg))
    dt_fast = (time.time() - t0) / it
    print(
        f"# akaze frontier: fast preset o3.s3.cs3 kp=1024: "
        f"{dt_fast * 1e3:.2f}ms ({1 / dt_fast:.1f} fps)",
        file=sys.stderr,
    )

    # batched AKAZE detection (B streams through ONE FED pipeline instance —
    # the frontend batch axis applied as a serving batch): per-stream
    # detect+describe cost at B=4
    from coloc_tpu.frontend import detect_and_describe_batch

    B = 4
    imgs_b = jnp.broadcast_to(jimg, (B,) + jimg.shape)

    @jax.jit
    def loop_batch(x):
        def body(i, c):
            f = detect_and_describe_batch(c, config.detector)
            live = (f.score.sum() + f.xy.sum()
                    + f.desc.astype(jnp.float32).sum())
            return imgs_b + live * 1e-12
        return jax.lax.fori_loop(0, max(2, it // 4), body, x)

    nb = max(2, it // 4)
    jax.block_until_ready(loop_batch(imgs_b))
    t0 = time.time()
    jax.block_until_ready(loop_batch(imgs_b))
    dt_b = (time.time() - t0) / nb
    print(
        f"# akaze batched detect B={B}: {dt_b * 1e3:.2f}ms/step = "
        f"{dt_b / B * 1e3:.2f}ms/stream ({B / dt_b:.1f} fps aggregate)",
        file=sys.stderr,
    )


def _bench_accuracy(config, cam, scene, K):
    """End-to-end pose accuracy vs ground truth on the rendered scene
    (stderr; the BASELINE 'pose error within 1%' check, GT-referenced since
    no OpenMVG oracle exists in this environment)."""
    import sys

    import jax
    import jax.numpy as jnp

    from coloc_tpu.frontend import detect_and_describe
    from coloc_tpu.geometry import so3
    from coloc_tpu.io import synthetic
    from coloc_tpu.matching import match_pair, match_with_map
    from coloc_tpu.robust import relative_pose_essential
    from coloc_tpu.sfm import localize, reconstruct
    from coloc_tpu.types import Pose

    R2 = np.asarray(so3.exp(jnp.asarray([0.01, -0.06, 0.005], jnp.float32)))
    C2 = np.array([0.5, 0.08, 0.0], np.float32)
    R3 = np.asarray(so3.exp(jnp.asarray([-0.02, 0.04, 0.01], jnp.float32)))
    C3 = np.array([0.25, -0.1, 0.05], np.float32)
    img1 = synthetic.render(scene, np.eye(3, dtype=np.float32),
                            np.zeros(3, np.float32))
    img2 = synthetic.render(scene, R2, C2)
    img3 = synthetic.render(scene, R3, C3)

    f1 = detect_and_describe(jnp.asarray(img1), config.detector)
    f2 = detect_and_describe(jnp.asarray(img2), config.detector)
    f3 = detect_and_describe(jnp.asarray(img3), config.detector)
    m = match_pair(f1, f2, config.matcher)
    geo = relative_pose_essential(
        jax.random.PRNGKey(0), f1.xy, f2.xy[m.idx], m.mask, cam, cam,
        config.ransac,
    )
    sc = reconstruct.two_view_scene(
        f1, f2, m, geo.inliers, geo.R, geo.t,
        Pose(R=jnp.eye(3), C=jnp.zeros(3)), float(np.linalg.norm(C2)),
        cam, cam, num_landmarks=config.max_landmarks,
    )
    Ks = jnp.stack([cam.K, cam.K])
    ds = jnp.stack([cam.dist, cam.dist])
    sc, _ = reconstruct.refine_scene(
        sc, Ks, ds, config.refiner, jnp.asarray([True, False])
    )
    mdb = reconstruct.scene_to_mapdb(sc)
    mm = match_with_map(f3, mdb, config.matcher)
    pwc, _ = localize.localize_image(
        jax.random.PRNGKey(1), f3, mm, mdb, cam, config.ransac, config.refiner
    )
    cosang = (np.trace(np.asarray(pwc.pose.R).T @ R3) - 1) / 2
    rot_err = float(np.degrees(np.arccos(np.clip(cosang, -1, 1))))
    c_err = float(np.linalg.norm(np.asarray(pwc.pose.C) - C3))
    baseline_dist = float(np.linalg.norm(C3))
    print(
        f"# accuracy: localization rot_err={rot_err:.3f} deg, "
        f"center_err={c_err * 100:.2f} cm "
        f"({c_err / baseline_dist * 100:.2f}% of trajectory scale), "
        f"inliers={int(pwc.n_tracks)}, success={bool(pwc.success)}",
        file=sys.stderr,
    )


def _bench_baseline_configs(config, cam, mapdb, img, feats0, iters):
    """Per-config timings for the five BASELINE.json benchmark configs
    (stderr report; opt-in via COLOC_BENCH_CONFIGS=1)."""
    import sys
    import time

    import jax
    import jax.numpy as jnp

    from coloc_tpu.frontend import detect_and_describe
    from coloc_tpu.matching import match_pair, match_with_map
    from coloc_tpu.robust import relative_pose_essential
    from coloc_tpu.sfm import localize

    key = jax.random.PRNGKey(0)

    def chain_bench(name, body):
        @jax.jit
        def loop(x):
            def step(i, c):
                out = body(jax.random.fold_in(key, i), c)
                return img + out * 1e-9
            return jax.lax.fori_loop(0, iters, step, x)
        jax.block_until_ready(loop(img))
        t0 = time.time()
        jax.block_until_ready(loop(img))
        dt = (time.time() - t0) / iters
        print(f"# config[{name}]: {dt * 1e3:.2f} ms/op = {1 / dt:.1f} ops/s",
              file=sys.stderr)

    # 1. two-view detect/describe/match
    def c1(k1, x):
        fa = detect_and_describe(x, config.detector)
        fb = detect_and_describe(x + 0.5, config.detector)
        m = match_pair(fa, fb, config.matcher)
        return m.best.sum().astype(jnp.float32) + fa.desc.sum().astype(jnp.float32) * 1e-9
    chain_bench("1 detect+describe+match pair", c1)

    # 2. two-view relative pose (5pt RANSAC + refinement)
    m0 = match_pair(feats0, feats0, config.matcher)
    def c2(k1, x):
        geo = relative_pose_essential(
            k1, feats0.xy + x[0, 0] * 1e-9, feats0.xy, m0.mask,
            cam, cam, config.ransac,
        )
        return geo.R[0, 0] + geo.n_inliers.astype(jnp.float32)
    chain_bench("2 relative pose (5pt RANSAC)", c2)

    # 3. map localization (P3P + refine)
    mm0 = match_with_map(feats0, mapdb, config.matcher)
    def c3(k1, x):
        pwc, _ = localize.localize_image(
            k1, feats0._replace(xy=feats0.xy + x[0, 0] * 1e-9), mm0, mapdb,
            cam, config.ransac, config.refiner,
        )
        return pwc.pose.C[0] + pwc.cov[0, 0]
    chain_bench("3 map localization (P3P+BA)", c3)

    # 4. inter-robot matching + ICI fusion
    from coloc_tpu.fusion import covint
    from coloc_tpu.matching import match_maps
    def c4(k1, x):
        mm = match_maps(mapdb, mapdb, config.matcher)
        CA = jnp.eye(3) * (1e-4 + x[0, 0] * 1e-12)
        f = covint.fuse(CA, CA * 2, jnp.zeros(3), jnp.ones(3) * 0.01)
        return f.pos[0] + mm.best.sum().astype(jnp.float32) * 1e-9
    chain_bench("4 map-map match + ICI fusion", c4)

    # 5. full collaborative session (host-orchestrated: includes dispatch
    # latency and the KF/logging host logic — the end-to-end system number)
    from coloc_tpu.geometry import so3
    from coloc_tpu.io import synthetic
    from coloc_tpu.session import ColocSession

    h = int(2 * float(cam.cy))
    w = int(2 * float(cam.cx))
    Kmat = np.asarray(cam.K)
    scn = synthetic.make_scene(h, w, Kmat, seed=2)
    frames = {}
    for d in range(2):
        Rs, Cs = synthetic.trajectory(4, d)
        frames[d] = [synthetic.render(scn, Rs[f], Cs[f]) for f in range(4)]
    sess = ColocSession(config, np.stack([Kmat] * 2),
                        np.zeros((2, 3), np.float32))
    if sess.init_map({0: frames[0][0], 1: frames[1][0]}):
        # warm the jit caches (batched all-drones step: one dispatch/frame)
        sess.intra_pose_all({0: frames[0][1], 1: frames[1][1]})
        n_ops = 0
        t0 = time.time()
        for rep in range(3):
            for f in (1, 2, 3):
                sess.intra_pose_all({d: frames[d][f] for d in (0, 1)})
                n_ops += 2
        dt5 = (time.time() - t0) / n_ops
        print(
            f"# config[5 full session intra step]: {dt5 * 1e3:.2f} ms/op = "
            f"{1 / dt5:.1f} ops/s (host-orchestrated, batched drone axis; "
            f"includes per-frame dispatch)",
            file=sys.stderr,
        )

        # 5b (device-resident chained stepping) runs in the DEFAULT bench
        # sections — see _bench_chained_session


if __name__ == "__main__":
    main()
