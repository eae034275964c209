"""Proof that the codec runs on the GPU through its public entry points.

    python chip_smoke.py               # one card: phases 1-6 and timings
    python chip_smoke.py --four-cards  # only the parallel_gops=4 lanes, on 4 cards

Seeded ``tools/ygen`` content at CIF (352x288), the resolution the
rate-control tables and the reference's deliverable exist for.  Phases:

1. device: JAX must find a GPU (never falls back to the CPU); the native
   entropy library must load.
2. full-search lane (block 8, r=2, QP 5, I_Period 10, 60 frames):
   ``encode_video`` then ``decode_video``, decode == reconstruction.  On 10
   frames the stream, mv.txt, coefficients and reconstruction equal
   ``backend="golden"``'s up to a first difference, which must be a float
   rounding tie: a coefficient (or reconstructed pixel) off by one where the
   exact float64 value sits on a .5 boundary (PARITY.md).  The
   exact-transform streams, QP 5 and QP 0, are byte-identical; at QP 0 the
   float DCT keeps |diff| <= 1 on < 1 % of coefficients.
3. deliverable lane (block 16, fastME, RC3, 2.4 Mbps, I_Period 21, 42
   frames): decode == reconstruction; on 21 frames the same golden trace
   as phase 2, and the exact-transform artifacts byte-identical.  The
   pipeline's own device-priced bits == host bits check runs every frame.
4. batch lane: ``encode_videos_batched`` over 8 full-search QP cells and 4
   fastME QP cells x 10 frames, every artifact byte-identical to serial
   ``encode_video`` runs.
5. fastME kernel parity at CIF vs golden/me.py (tolerance 0: integer SADs)
   in MVs, SADs and comparison counts, block 8/16, 1/4 references, fracME
   on/off, n_valid warm-up, and under ``vmap`` (one grid program per lane).
6. decode in a fresh process: the phase 2 and 3 streams decode to the
   reconstruction of the process that encoded them.

The parent process never imports JAX.  It runs the phases in child
processes, one after another: the card's phases and timings first, then
the golden oracle held to the CPU (``JAX_PLATFORMS=cpu``), so no timing
shares the host with it.  A failing phase makes the script exit non-zero;
the last line of a passing run is one JSON object
``{"ok": true, "device": {...}}``.  Artifacts go to ``.smoke/``.
"""

import argparse
import csv
import filecmp
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
W, H = 352, 288
SEED = 42
DELIVERABLE = dict(block_size=16, search_range=1, I_Period=21,
                   quantization_factor=5, fastME=True, RCflag=3,
                   targetBR=2_400_000)
FULL_SEARCH = dict(block_size=8, search_range=2, I_Period=10,
                   quantization_factor=5)
FASTME = dict(block_size=16, search_range=1, I_Period=10, fastME=True)
# batch lane: (group, base config, QP cells)
BATCH = (("p4", FULL_SEARCH, tuple(range(8))), ("p4f", FASTME, (0, 2, 4, 6)))
# (block size, references, fracME, n_valid) of the kernel parity grid
ME_GRID = [(bs, nr, fr, None) for bs in (8, 16) for nr in (1, 4)
           for fr in (False, True)] + [(bs, 4, fr, 2) for bs in (8, 16)
                                       for fr in (False, True)]
# (block size, references, fracME) run under vmap, one lane per frame pair
VMAP_GRID = [(16, 1, False), (16, 4, True), (8, 2, True)]
LANES = 4
# float runs whose first difference from golden is traced to its cause
TRACED = ("p2", "p2q0", "p3")
# run name -> (frames, config, backend); one directory per run under WORK
RUNS = {
    "p2": (60, FULL_SEARCH, "device"),
    "p3": (42, DELIVERABLE, "device"),
}
for _b in ("device", "golden"):
    RUNS[f"p2_{_b}"] = (10, FULL_SEARCH, _b)
    RUNS[f"p2x_{_b}"] = (10, dict(FULL_SEARCH, exact_transform=True), _b)
    RUNS[f"p2q0x_{_b}"] = (10, dict(FULL_SEARCH, quantization_factor=0,
                                    exact_transform=True), _b)
    RUNS[f"p2q0_{_b}"] = (10, dict(FULL_SEARCH, quantization_factor=0), _b)
    RUNS[f"p3_{_b}"] = (21, DELIVERABLE, _b)
    RUNS[f"p3x_{_b}"] = (21, dict(DELIVERABLE, exact_transform=True), _b)
for _g, _cfg, _qps in BATCH:
    for _q in _qps:
        for _lane in ("batch", "serial"):
            RUNS[f"{_g}{_lane}_q{_q}"] = (
                10, dict(_cfg, quantization_factor=_q), "device")
ARTIFACTS = ("encoded", "mv", "qdct", "res_w", "res_wo", "recon")


def params(name, parallel_gops=0, config=None, frames=None):
    """InputParameters of run ``name`` (its input file lives in its dir)."""
    from basic_video_codec_tpu import EncoderConfig, InputParameters

    n, cfg, backend = RUNS.get(name, (frames, config, "device"))
    d = os.path.join(WORK, name.split("_q")[0] if name.startswith("p4") else name)
    ec = EncoderConfig(**cfg, resolution=(W, H), backend=backend,
                       parallel_gops=parallel_gops)
    return InputParameters(os.path.join(d, "s.y"), W, H, ec,
                           frames_to_process=n)


def artifact_paths(p):
    from basic_video_codec_tpu.io.fileio import FileIOHelper

    io = FileIOHelper(p, create_dirs=False)
    return dict(encoded=io.get_encoded_file_name(), mv=io.get_mv_file_name(),
                qdct=io.get_quant_dct_coff_fh_file_name(),
                res_w=io.get_residual_w_mc_file_name(),
                res_wo=io.get_residual_wo_mc_file_name(),
                recon=io.get_mc_reconstructed_file_name(),
                decoded=io.get_mc_decoded_file_name(),
                metrics=io.get_metrics_csv_file_name())


def same_file(a, b):
    return filecmp.cmp(a, b, shallow=False)


def check(ok, msg):
    if not ok:
        raise SystemExit(f"FAIL: {msg}")


def same_trees(pa, pb, label):
    """Every artifact byte-identical; metrics.csv equal outside its
    wall-clock columns."""
    a, b = artifact_paths(pa), artifact_paths(pb)
    for key in ARTIFACTS:
        check(same_file(a[key], b[key]), f"{label}: {key} differs")
    with open(a["metrics"]) as fa, open(b["metrics"]) as fb:
        ra, rb = list(csv.reader(fa)), list(csv.reader(fb))
    timing = {i for i, c in enumerate(ra[0])
              if "time" in c.lower() or "elapsed" in c.lower()}
    check(len(ra) == len(rb) and all(
        [v for i, v in enumerate(x) if i not in timing]
        == [v for i, v in enumerate(y) if i not in timing]
        for x, y in zip(ra, rb)), f"{label}: metrics.csv differs")


def decode_matches(p):
    import numpy as np

    a = artifact_paths(p)
    return np.array_equal(np.fromfile(a["recon"], np.uint8),
                          np.fromfile(a["decoded"], np.uint8))


def card():
    """``name, power.limit`` lines of every card, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def me_inputs(bs, n_ref, frac, lane=0):
    """Current frame, references and half-pel planes; lane k shifts the
    whole window k frames along the sequence."""
    import numpy as np

    from basic_video_codec_tpu.golden.interp import build_pre_interpolated_buffer
    from basic_video_codec_tpu.tools import ygen

    seq = ygen.moving_sequence(W, H, 5 + lane, seed=SEED)
    refs = seq[lane:lane + n_ref]
    hps = (np.stack([build_pre_interpolated_buffer(r) for r in refs]) if frac
           else np.zeros((n_ref, 2 * H, 2 * W), np.uint8))
    return seq[4 + lane], refs, hps


def me_key(bs, n_ref, frac, nv, lane=None):
    key = f"bs{bs}_ref{n_ref}_{'frac' if frac else 'int'}_nv{nv}"
    return key if lane is None else f"{key}_vmap{lane}"


def me_cases():
    """Every (key, block size, references, fracME, n_valid, lane) the
    kernel parity phase compares with golden."""
    return ([(me_key(*c), *c, 0) for c in ME_GRID]
            + [(me_key(bs, nr, fr, None, k), bs, nr, fr, None, k)
               for bs, nr, fr in VMAP_GRID for k in range(LANES)])


# --------------------------------------------------------------------------
# children
# --------------------------------------------------------------------------

def record_golden(name):
    """Golden encode of run ``name`` that keeps every frame's final-pass
    DCT inputs (residual blocks in raster order) and QPs, so a difference
    from the device can be traced to the block and value it starts at."""
    import numpy as np

    from basic_video_codec_tpu import encode_video
    from basic_video_codec_tpu.golden import dct as gdct, encoder as genc

    passes = []  # (1-based frame index, [(residual, qp), ...]) per pass
    encode_frame, dct_quant = genc._encode_frame, gdct.apply_dct_and_quantization

    def recording_encode_frame(frame, ec):
        passes.append((frame.index, []))
        encode_frame(frame, ec)

    def recording_dct_quant(residual, bs, qp, exact=False):
        passes[-1][1].append((np.array(residual, np.int16), qp))
        return dct_quant(residual, bs, qp, exact)

    genc._encode_frame = recording_encode_frame
    gdct.apply_dct_and_quantization = recording_dct_quant
    try:
        encode_video(params(name), results_csv_path=None)
    finally:
        genc._encode_frame, gdct.apply_dct_and_quantization = (
            encode_frame, dct_quant)
    final = dict(passes)  # RC 2/3: the second pass overwrites the first
    frames = [final[i] for i in sorted(final)]
    np.savez(os.path.join(WORK, f"trace_{name}.npz"),
             res=np.array([[r for r, _ in f] for f in frames]),
             qp=np.array([[q for _, q in f] for f in frames]))


def child_golden():
    """Golden oracle encodes and per-block fastME, on the host CPU."""
    import types

    import numpy as np

    from basic_video_codec_tpu import encode_video
    from basic_video_codec_tpu.golden import me as gme

    for name, (_, _, backend) in RUNS.items():
        if backend != "golden":
            continue
        if name.removesuffix("_golden") in TRACED:
            record_golden(name)
        else:
            encode_video(params(name), results_csv_path=None)
    out = {}
    for key, bs, n_ref, frac, nv, lane in me_cases():
        curr, refs, hps = me_inputs(bs, n_ref, frac, lane)
        n = n_ref if nv is None else nv
        ec = types.SimpleNamespace(block_size=bs, fracMeEnabled=frac)
        shape = (H // bs, W // bs)
        mvs, sads, comps = (np.zeros(shape + (3,), np.int32),
                            np.zeros(shape, np.int32), np.zeros(shape, np.int32))
        mvp = (0, 0)
        for y in range(0, H, bs):
            for x in range(0, W, bs):
                mv, mae, c = gme.fast_search(
                    curr[y:y + bs, x:x + bs].astype(np.int16), (x, y), mvp,
                    list(refs[:n]), list(hps[:n]), ec, 0)
                mvs[y // bs, x // bs] = mv
                sads[y // bs, x // bs] = round(mae * bs * bs)
                comps[y // bs, x // bs] = c
                mvp = mv
        out.update({key + "_mvs": mvs, key + "_sads": sads,
                    key + "_comps": comps})
    np.savez(os.path.join(WORK, "me_golden.npz"), **out)


def timeit(fn, *args, reps=10, rounds=3):
    """Best-of-rounds mean ms per call, dispatch included, result waited."""
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            r = fn(*args)
        jax.block_until_ready(r)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best * 1e3


def timed_encode(p, encode):
    """Steady-state seconds of an encode whose programs are compiled."""
    t0 = time.perf_counter()
    encode(p, results_csv_path=None)
    return time.perf_counter() - t0


def child_device():
    """Phases 1-5 and the timings, on the card."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"FAIL: JAX found no GPU (platform "
                         f"{devs[0].platform!r}); this script never falls back")
    import jax.numpy as jnp
    import numpy as np

    from basic_video_codec_tpu import decode_video, encode_video
    from basic_video_codec_tpu.entropy import native
    from basic_video_codec_tpu.models.batch import encode_videos_batched
    from basic_video_codec_tpu.utils import compcache

    compcache.enable()
    lib = native.available()
    gpu = card()
    print(f"phase 1 device: {devs[0].device_kind} x{len(devs)} ({gpu}), "
          f"jax {jax.__version__}, native entropy library "
          f"{'loaded' if lib else 'MISSING'}", flush=True)
    check(lib, "native entropy library did not load")
    with open(os.path.join(WORK, "device.json"), "w") as f:
        json.dump({"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": len(devs)}, f)

    # phase 2: full-search lane
    t0 = time.perf_counter()
    p2 = params("p2")
    encode_video(p2, results_csv_path=None)
    compile2 = time.perf_counter() - t0
    fps2 = 60 / timed_encode(p2, encode_video)
    decode_video(p2)
    check(decode_matches(p2), "phase 2: decode != reconstruction")
    for name in ("p2_device", "p2x_device", "p2q0x_device", "p2q0_device"):
        encode_video(params(name), results_csv_path=None)
    # the float DCT's +-1 edge at QP 0, op level: real residual blocks
    from basic_video_codec_tpu.golden import dct as gdct
    from basic_video_codec_tpu.ops import transform as T
    from basic_video_codec_tpu.tools import ygen

    seq = ygen.moving_sequence(W, H, 3, seed=SEED).astype(np.int16)
    res = np.concatenate([(seq[k + 1] - seq[k]).reshape(H // 8, 8, W // 8, 8)
                          .swapaxes(1, 2).reshape(-1, 8, 8) for k in range(2)])
    dev_q = np.asarray(T.quantize(T.forward_coeffs(jnp.asarray(res), 8, False),
                                  jnp.asarray(T.quant_matrices(8)[0])))
    gold_q = np.stack([gdct.apply_dct_and_quantization(b, 8, 0)[0] for b in res])
    diff = np.abs(dev_q.astype(np.int64) - gold_q.astype(np.int64))
    frac_diff = float((diff != 0).mean())
    print(f"phase 2 full-search lane: decode == recon over 60 frames; "
          f"{fps2:.2f} fps steady, {compile2:.1f} s first run ({gpu}); "
          f"QP 0 float DCT vs golden: {int((diff != 0).sum())} of {diff.size} "
          f"coefficients differ, max |diff| {int(diff.max())}", flush=True)
    check(diff.max() <= 1 and frac_diff < 1e-2,
          "phase 2: float DCT outside the +-1 on < 1 % tolerance")

    # phase 3: deliverable lane
    t0 = time.perf_counter()
    p3 = params("p3")
    encode_video(p3, results_csv_path=None)
    compile3 = time.perf_counter() - t0
    fps3 = 42 / timed_encode(p3, encode_video)
    decode_video(p3)
    check(decode_matches(p3), "phase 3: decode != reconstruction")
    for name in ("p3_device", "p3x_device"):
        encode_video(params(name), results_csv_path=None)
    print(f"phase 3 deliverable lane: decode == recon over 42 frames, "
          f"device-priced bits == host bits every frame; {fps3:.2f} fps "
          f"steady, {compile3:.1f} s first run ({gpu})", flush=True)

    # phase 4: batch lane vs serial
    for group, _, qps in BATCH:
        cells_b = [params(f"{group}batch_q{q}") for q in qps]
        cells_s = [params(f"{group}serial_q{q}") for q in qps]
        res_b = encode_videos_batched(cells_b, results_csv_path=None)
        check(res_b.n_batched == 1, f"phase 4 {group}: cells not batched")
        for p in cells_s:
            encode_video(p, results_csv_path=None)
        for q, pb, ps in zip(qps, cells_b, cells_s):
            same_trees(pb, ps, f"phase 4 {group} QP {q} batched vs serial")
        t0 = time.perf_counter()
        encode_videos_batched(cells_b, results_csv_path=None)
        fps_b = 10 * len(qps) / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for p in cells_s:
            encode_video(p, results_csv_path=None)
        fps_s = 10 * len(qps) / (time.perf_counter() - t0)
        kind = "fastME" if group == "p4f" else "full-search"
        print(f"phase 4 batch lane: {len(qps)} {kind} QP cells x 10 frames "
              f"byte-identical to serial; {fps_b:.2f} config-frames/s "
              f"batched, {fps_s:.2f} serial ({gpu})", flush=True)

    # phase 5: the compiled fastME kernel at CIF (compared in the parent)
    from basic_video_codec_tpu.ops.fastme import fast_search_frame_xla
    from basic_video_codec_tpu.ops.fastme_pallas import fast_search_frame_pallas

    out, ab = {}, []
    for bs, n_ref, frac, nv in ME_GRID:
        curr, refs, hps = (jnp.asarray(a) for a in me_inputs(bs, n_ref, frac))
        nvj = None if nv is None else jnp.int32(nv)
        key = me_key(bs, n_ref, frac, nv)
        got = fast_search_frame_pallas(curr, refs, hps, bs, frac, n_valid=nvj)
        for part, v in zip(("mvs", "sads", "comps"), got):
            out[f"{key}_{part}"] = np.asarray(v)
        if nv is None:
            ab.append((key, timeit(lambda *a: fast_search_frame_pallas(
                *a, bs, frac), curr, refs, hps),
                timeit(lambda *a: fast_search_frame_xla(*a, bs, frac),
                       curr, refs, hps, reps=2, rounds=2)))
    for bs, n_ref, frac in VMAP_GRID:
        lanes = [me_inputs(bs, n_ref, frac, k) for k in range(LANES)]
        got = jax.vmap(lambda c, r, h: fast_search_frame_pallas(
            c, r, h, bs, frac))(*(jnp.asarray(np.stack(a)) for a in zip(*lanes)))
        for k in range(LANES):
            key = me_key(bs, n_ref, frac, None, k)
            for part, v in zip(("mvs", "sads", "comps"), got):
                out[f"{key}_{part}"] = np.asarray(v[k])
    np.savez(os.path.join(WORK, "me_device.npz"), **out)
    print(f"phase 5 fastME kernel: compiled and run at CIF on {len(ME_GRID)} "
          f"configurations and {len(VMAP_GRID)} vmapped ones of {LANES} "
          "lanes (compared with golden below)", flush=True)
    for key, tk, tx in ab:
        print(f"timing fastME walk {key}: kernel {tk:.3f} ms, XLA walk "
              f"{tx:.3f} ms per CIF frame ({gpu})", flush=True)
    timings_ab(p3, fps3, gpu)


def timings_ab(p3, fps3, gpu):
    """A/B timings of the kernels and idioms the GPU path chose between."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from basic_video_codec_tpu import encode_video
    from basic_video_codec_tpu.entropy.zigzag import zigzag_indices
    from basic_video_codec_tpu.ops import fastme_pallas, pack
    from basic_video_codec_tpu.ops.bitlen import zigzag_rows
    from basic_video_codec_tpu.ops.me import full_search
    from basic_video_codec_tpu.tools import ygen

    # the deliverable end to end with the XLA walk in place of the kernel
    use_kernel = fastme_pallas.use_pallas_fastme
    fastme_pallas.use_pallas_fastme = lambda: False
    jax.clear_caches()
    try:
        encode_video(p3, results_csv_path=None)
        fps_x = 42 / timed_encode(p3, encode_video)
    finally:
        fastme_pallas.use_pallas_fastme = use_kernel
        jax.clear_caches()
    print(f"timing deliverable end to end: {fps3:.2f} fps with the fastME "
          f"kernel, {fps_x:.2f} fps with the XLA walk ({gpu})", flush=True)

    rng = np.random.default_rng(0)
    for bs in (8, 16):
        nb = (H // bs) * (W // bs)
        x = jnp.asarray(rng.integers(-40, 40, (64, nb, bs * bs)), jnp.int32)
        sel = np.zeros((bs * bs, bs * bs), np.float32)
        sel[zigzag_indices(bs), np.arange(bs * bs)] = 1.0
        matmul = jax.jit(lambda v: jnp.dot(
            v.astype(jnp.float32), sel,
            precision=jax.lax.Precision.HIGHEST).astype(jnp.int32))
        gather = jax.jit(lambda v: zigzag_rows(v, bs))
        check(np.array_equal(matmul(x), gather(x)), "zigzag forms differ")
        print(f"timing zigzag block {bs}, 64 CIF frames: gather "
              f"{timeit(gather, x):.4f} ms, selector matmul "
              f"{timeit(matmul, x):.4f} ms ({gpu})", flush=True)

    n, k = H * W, 8
    keep = jnp.asarray(rng.random((k, n)) < 0.3)
    p8 = jnp.asarray(rng.integers(0, 255, (k, n)), jnp.uint8)
    p16 = jnp.asarray(rng.integers(-99, 99, (k, n)), jnp.int16)
    ms = {}
    for name, f in (("sort", pack.compact_stream_sort),
                    ("scatter", pack.compact_stream_scatter)):
        g = jax.jit(jax.vmap(lambda a, b, c, f=f: f(a, (b, c), n * 3 // 8)))
        ms[name] = timeit(g, keep, p8, p16, reps=2, rounds=2)
    print(f"timing stream compaction, 8 CIF planes: sort {ms['sort']:.3f} ms, "
          f"scatter {ms['scatter']:.3f} ms ({gpu})", flush=True)

    seq = ygen.moving_sequence(W, H, 2, seed=SEED)
    curr, refs = jnp.asarray(seq[1]), jnp.asarray(seq[:1])
    hps = jnp.zeros((1, 2 * H, 2 * W), jnp.uint8)
    for r in (2, 8):
        t = timeit(lambda c, rr, hh: full_search(c, rr, hh, 8, r, False),
                   curr, refs, hps)
        print(f"timing full search (plain XLA) block 8, r={r}: {t:.3f} ms per "
              f"CIF frame ({gpu})", flush=True)


def child_decode():
    """Phase 6: decode the device streams in a process of its own."""
    import jax

    check(jax.devices()[0].platform == "gpu", "decode child found no GPU")
    from basic_video_codec_tpu import decode_video
    from basic_video_codec_tpu.utils import compcache

    compcache.enable()
    for name in ("p2", "p3"):
        p = params(name)
        os.remove(artifact_paths(p)["decoded"])
        decode_video(p)
        check(decode_matches(p), f"phase 6: fresh-process decode of {name} "
                                 "!= the encoder's reconstruction")
    print("phase 6 fresh-process decode: phase 2 and 3 streams decode to the "
          "encoder's reconstruction", flush=True)


def child_four():
    """The GOP-sharded lanes on four cards vs a one-card serial run."""
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu" and len(devs) >= 4,
          f"--four-cards needs 4 GPUs; JAX found {len(devs)} "
          f"{devs[0].platform} device(s)")
    from basic_video_codec_tpu import decode_video, encode_video
    from basic_video_codec_tpu.models import pipeline
    from basic_video_codec_tpu.utils import compcache

    compcache.enable()
    gpu = card().replace("\n", "; ")
    lanes = {
        "rc1": dict(block_size=16, search_range=2, I_Period=4,
                    quantization_factor=5, RCflag=1, targetBR=2_400_000),
        "rc3": dict(DELIVERABLE, I_Period=4),
    }
    for lane, cfg in lanes.items():
        got = {}
        for mode, pg in (("serial", 0), ("sharded", 4)):
            RUNS[f"{lane}_{mode}"] = (17, cfg, "device")
            p = params(f"{lane}_{mode}", parallel_gops=pg)
            t0 = time.perf_counter()
            encode_video(p, results_csv_path=None)
            got[mode] = (p, time.perf_counter() - t0)
            if pg:
                used = pipeline.LAST_RUN_STATS.get("devices")
                check(used == 4, f"{lane}: sharded run used {used} devices")
        same_trees(got["sharded"][0], got["serial"][0], f"{lane} 4 cards vs 1")
        decode_video(got["sharded"][0])
        check(decode_matches(got["sharded"][0]),
              f"four cards {lane}: decode != reconstruction")
        print(f"four cards {lane} lane (parallel_gops=4, CIF block 16, 17 "
              f"frames): byte-identical to the 1-card serial run, decode == "
              f"recon; first-run seconds {got['sharded'][1]:.1f} sharded, "
              f"{got['serial'][1]:.1f} serial ({gpu})", flush=True)
    with open(os.path.join(WORK, "device.json"), "w") as f:
        json.dump({"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": len(devs)}, f)


# --------------------------------------------------------------------------
# parent
# --------------------------------------------------------------------------

def write_inputs(names):
    from basic_video_codec_tpu.tools import ygen

    seq = ygen.moving_sequence(W, H, max(RUNS[n][0] for n in names), seed=SEED)
    for n in names:
        p = params(n)
        os.makedirs(os.path.dirname(p.y_only_file), exist_ok=True)
        ygen.write_y_file(p.y_only_file, seq[:RUNS[n][0]])


def run(role, **env):
    """Run one child to its end (only one process holds the card)."""
    cmd = [sys.executable, os.path.abspath(__file__), "--child", role]
    rc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, **env)).returncode
    check(rc == 0, f"{role} child exited with {rc}")


def dct64(n):
    """Orthonormal DCT-II matrix in float64: the exact transform."""
    import numpy as np

    k, m = np.arange(n)[:, None], np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * m + 1) * k / (2 * n))
    d[0] *= np.sqrt(1 / n)
    d[1:] *= np.sqrt(2 / n)
    return d


def stream_frames(path):
    """encoded.bin cut into frames: [1B mode][2B len][pred][3B len][dct]."""
    with open(path, "rb") as f:
        data = f.read()
    out, pos = [], 0
    while pos < len(data):
        dct_at = pos + 3 + int.from_bytes(data[pos + 1:pos + 3], "big")
        end = dct_at + 3 + int.from_bytes(data[dct_at:dct_at + 3], "big")
        out.append(data[pos:end])
        pos = end
    return out


def trace_to_tie(tag, name):
    """Device vs golden artifacts of float run ``name``: identical, or
    identical (stream, mv.txt, coefficients, reconstruction) up to a first
    frame whose first differing block differs only by rounding ties.

    The float DCT of an integer block puts some coefficients exactly on a
    rational value (the DC term is the block sum / bs), so ``round(dct / Q)``
    meets exact .5 ties that float32 rounding on either side settles
    either way; the same holds for ``round(idct + pred)``.  Every differing
    coefficient (or, with the coefficients equal, every differing pixel) of
    the first differing block must be off by one where the float64 value
    lies within float32 error of a .5 boundary.  The block's DCT input
    comes from the golden encode (record_golden), which is valid there
    because everything before it is identical."""
    import numpy as np

    from basic_video_codec_tpu.golden import dct as gdct

    n, cfg, _ = RUNS[f"{name}_golden"]
    bs = cfg["block_size"]
    dev, gold = (artifact_paths(params(f"{name}_{b}"))
                 for b in ("device", "golden"))

    def planes(p, key, dtype):
        return np.fromfile(p[key], dtype).reshape(-1, H, W)

    def mvs(p):
        with open(p["mv"]) as f:
            return f.read().split("\n")[:n]

    arts = [(planes(p, "qdct", np.int16), planes(p, "recon", np.uint8),
             mvs(p), stream_frames(p["encoded"])) for p in (dev, gold)]
    check(all(len(a) == n for a in arts[0] + arts[1]),
          f"{tag}: an artifact does not hold {n} frames")
    (qd, rd, md, sd), (qg, rg, mg, sg) = arts
    same = [np.array_equal(qd[f], qg[f]) and np.array_equal(rd[f], rg[f])
            and md[f] == mg[f] and sd[f] == sg[f] for f in range(n)]
    if all(same):
        return f"identical to golden over {n} frames"
    f = same.index(False)
    check(md[f] == mg[f], f"{tag}: mv.txt differs from golden in frame {f}")

    def blocks(a):
        return a.reshape(H // bs, bs, W // bs, bs).swapaxes(1, 2).reshape(
            -1, bs, bs)

    qdb, qgb, rdb, rgb = blocks(qd[f]), blocks(qg[f]), blocks(rd[f]), blocks(rg[f])
    bad = np.flatnonzero((qdb != qgb).any((1, 2)) | (rdb != rgb).any((1, 2)))
    check(bad.size > 0, f"{tag}: frame {f} stream differs from golden with "
                        "identical coefficients and reconstruction")
    b = int(bad[0])
    trace = np.load(os.path.join(WORK, f"trace_{name}_golden.npz"))
    res = trace["res"][f, b].astype(np.float64)
    Q = gdct.generate_quantization_matrix(bs, int(trace["qp"][f, b])).astype(
        np.float64)
    d = dct64(bs)
    if (qdb[b] != qgb[b]).any():
        kind, got, want = "DCT coefficient", qdb[b], qgb[b]
        exact = d @ res @ d.T / Q
        tol = 1e-4 + 2.0 ** -22 * np.abs(res).sum() / Q
    else:
        kind, got, want = "reconstructed pixel", rdb[b], rgb[b]
        y_plane = np.fromfile(params(f"{name}_golden").y_only_file, np.uint8)
        curr = blocks(y_plane.reshape(-1, H, W)[f].astype(np.float64))[b]
        coeffs = qgb[b] * Q
        exact = d.T @ coeffs @ d + (curr - res)  # prediction = curr - res
        tol = 1e-4 + 2.0 ** -22 * np.abs(coeffs).sum()
    tol = np.broadcast_to(tol, exact.shape)
    off = np.abs(exact - np.floor(exact) - 0.5)
    diff = np.abs(got.astype(np.int64) - want)
    where = np.argwhere(diff != 0)
    for i, j in where:
        check(diff[i, j] == 1 and off[i, j] <= tol[i, j],
              f"{tag}: frame {f} block {b}: {kind} [{i}, {j}] device "
              f"{got[i, j]}, golden {want[i, j]}, exact value "
              f"{exact[i, j]!r} is not a rounding tie")
    i, j = where[0]
    x, y = (b % (W // bs)) * bs, (b // (W // bs)) * bs
    return (f"{f} of {n} frames identical to golden, then frame {f}, block "
            f"({x}, {y}) differs by {len(where)} rounding tie(s): "
            f"{kind} [{i}, {j}] device {got[i, j]}, golden {want[i, j]}, "
            f"exact value {exact[i, j]:.9f} (off a .5 boundary by "
            f"{off[i, j]:.1e}); mv.txt identical through frame {f}")


def compare_golden():
    """Phases 2, 3 and 5: device artifacts vs the golden oracle's."""
    import numpy as np

    def exact_same(name):
        a, b = (artifact_paths(params(f"{name}_{k}"))
                for k in ("device", "golden"))
        return all(same_file(a[k], b[k]) for k in ARTIFACTS)

    check(exact_same("p2x") and exact_same("p2q0x"),
          "phase 2: an exact-transform run differs from golden")
    print(f"phase 2 golden parity (10 frames): QP 5 float stream "
          f"{trace_to_tie('phase 2', 'p2')}", flush=True)
    print(f"phase 2 golden parity (10 frames): QP 0 float stream "
          f"{trace_to_tie('phase 2 QP 0', 'p2q0')}", flush=True)
    print("phase 2 golden parity: exact-transform QP 5 and QP 0 artifacts "
          "byte-identical to golden", flush=True)
    check(exact_same("p3x"), "phase 3: the exact-transform run differs "
                             "from golden")
    print(f"phase 3 golden parity (21 frames): {trace_to_tie('phase 3', 'p3')}"
          "; exact-transform artifacts byte-identical to golden", flush=True)
    dev = np.load(os.path.join(WORK, "me_device.npz"))
    gold = np.load(os.path.join(WORK, "me_golden.npz"))
    check(sorted(dev.files) == sorted(gold.files), "phase 5: case lists differ")
    for key in gold.files:
        check(np.array_equal(dev[key], gold[key]),
              f"phase 5: fastME kernel {key} differs from golden")
    print(f"phase 5 fastME kernel parity: MVs, SADs and comparison counts "
          f"equal golden/me.py exactly on {len(ME_GRID)} CIF configurations "
          f"and {len(VMAP_GRID) * LANES} vmapped lanes", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the parallel_gops=4 lanes, on 4 cards")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        import logging

        logging.disable(logging.INFO)
        {"golden": child_golden, "device": child_device,
         "decode": child_decode, "four": child_four}[args.child]()
        return
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t0 = time.perf_counter()
    if args.four_cards:
        from basic_video_codec_tpu.tools import ygen

        for lane in ("rc1", "rc3"):
            for mode in ("serial", "sharded"):
                d = os.path.join(WORK, f"{lane}_{mode}")
                os.makedirs(d)
                ygen.write_y_file(os.path.join(d, "s.y"),
                                  ygen.moving_sequence(W, H, 17, seed=SEED))
        run("four")
    else:
        write_inputs(list(RUNS))
        run("device")
        run("decode")
        run("golden", JAX_PLATFORMS="cpu")
        compare_golden()
    with open(os.path.join(WORK, "device.json")) as f:
        device = json.load(f)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
