"""Headline benchmark: CIF P-frame encode throughput on the GPU.

Reproduces the reference's best published configuration class
(results.csv rows 1-20: full-search ME, block 8, r=2, CIF, single
reference — 0.39-0.69 fps on the reference's CPU; BASELINE.md) end-to-end
through the public ``encode_video`` API: motion search + MC + DCT +
quantization + reconstruction on device, entropy bitstream + artifact files
on host, everything written to disk exactly like the reference run.

Also measures the reference's flagship deliverable config (CIF RC3 + fastME,
block 16, I_Period 21, targetBR 2.4 Mbps — reference assign3/Deliverable.py:14-45,
1.35 fps baseline) and reports it as ``deliverable_fps`` /
``deliverable_vs_baseline`` in the same JSON line.

Third leg: the batch lane (models/batch.py) on a fixed RD-sweep-like group
(8 QP cells x 10 frames of the headline config class — the reference
sweep drivers' actual cell shape, assign1/ex4_plots.py:131-257 encodes 10
frames per cell) vs the same cells run serially: ``sweep_fps_aggregate``
(batched config-frames/s), ``sweep_fps_serial``, ``sweep_speedup``.
(Cells longer than the fill/drain-dominated region route serial, so the
sweep leg measures the region the reference drivers occupy.)

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...,
"device": {platform, kind, count, card}}.  Exits non-zero, printing no
result, when JAX finds no GPU.
"""

import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

BASELINE_FPS = 0.69  # reference results.csv best full-search row (BASELINE.md)
DELIVERABLE_BASELINE_FPS = 1.35  # reference results.csv fastME tail (SURVEY §6)

W, H = 352, 288
BLOCK, R, QP, IPERIOD = 8, 2, 5, 10  # I_Period 10 = the reference RD sweep's largest
WARMUP_FRAMES = 20  # covers the chunked I+P compile paths
# 240 frames measures SUSTAINED throughput: at ~170 fps a run is ~1.4 s, so
# the fixed pipeline fill/drain (~0.1 s: first-chunk fetch latency + final
# drain) amortizes to noise instead of costing ~10% as it did at 80 frames
BENCH_FRAMES = 240
# best-of-reps within a fixed sampling window
MIN_REPS = 4
MAX_REPS = 60
SAMPLE_SECONDS = 150


def main():
    logging.disable(logging.INFO)
    import jax

    dev = jax.devices()
    if dev[0].platform != "gpu":
        print(f"bench.py measures the GPU; JAX found {dev[0].platform!r}",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    device = {"platform": dev[0].platform, "kind": dev[0].device_kind,
              "count": len(dev), "card": card[0]}
    from basic_video_codec_tpu.config import EncoderConfig, InputParameters
    from basic_video_codec_tpu.models.pipeline import encode_video
    from basic_video_codec_tpu.tools import ygen
    from basic_video_codec_tpu.utils import compcache

    # persistent XLA cache: repeat benches read the warm-up legs' programs
    # from disk; the measured steady state is untouched
    compcache.enable()

    tmp = tempfile.mkdtemp(prefix="bvc_bench_")
    try:
        y_path = os.path.join(tmp, "bench_cif.y")
        frames = ygen.moving_sequence(W, H, BENCH_FRAMES, seed=42)
        ygen.write_y_file(y_path, frames)

        def run(n_frames):
            ec = EncoderConfig(
                block_size=BLOCK, search_range=R, I_Period=IPERIOD,
                quantization_factor=QP, resolution=(W, H),
            )
            params = InputParameters(y_path, W, H, ec, frames_to_process=n_frames)
            t0 = time.time()
            encode_video(params, results_csv_path=None)
            return time.time() - t0

        run(WARMUP_FRAMES)            # compile the chunked I+P programs
        # steady-state, end-to-end incl. file IO
        times = []
        t_start = time.time()
        while len(times) < MIN_REPS or (time.time() - t_start < SAMPLE_SECONDS
                                        and len(times) < MAX_REPS):
            times.append(run(BENCH_FRAMES))
        fps = BENCH_FRAMES / min(times)
        median_fps = BENCH_FRAMES / statistics.median(times)

        # flagship deliverable config (assign3/Deliverable.py): RC3 + fastME
        def run_deliverable(n_frames):
            ec = EncoderConfig(
                block_size=16, search_range=1, I_Period=21,
                quantization_factor=5, fastME=True, RCflag=3,
                targetBR=2_400_000, resolution=(W, H),
            )
            params = InputParameters(y_path, W, H, ec, frames_to_process=n_frames)
            t0 = time.time()
            encode_video(params, results_csv_path=None)
            return time.time() - t0

        run_deliverable(42)           # compile the two-pass programs
        d_times = []
        t_start = time.time()
        while len(d_times) < MIN_REPS or (time.time() - t_start < 60
                                          and len(d_times) < MAX_REPS):
            d_times.append(run_deliverable(BENCH_FRAMES))
        deliverable_fps = BENCH_FRAMES / min(d_times)

        # batch lane: 8 QP cells of the headline class, batched vs serial.
        # Each cell encodes the same SWEEP_FRAMES-frame stream (the
        # reference sweep drivers' 10-frame cell shape); separate y dirs
        # so the batched and serial trees never collide; artifacts
        # overwrite in place across reps (overwrite_open keeps rep N+1
        # off rep N's ext4 writeback).
        from basic_video_codec_tpu.models.batch import encode_videos_batched

        SWEEP_QPS = list(range(8))
        SWEEP_FRAMES = 10  # the reference sweep drivers' per-cell length
        y_sweep = {}
        for lane in ("sb", "ss"):
            d = os.path.join(tmp, lane)
            os.makedirs(d, exist_ok=True)
            y_sweep[lane] = os.path.join(d, "sweep.y")
            ygen.write_y_file(y_sweep[lane], frames[:SWEEP_FRAMES])

        def sweep_cells(lane):
            out = []
            for qp in SWEEP_QPS:
                ec = EncoderConfig(
                    block_size=BLOCK, search_range=R, I_Period=IPERIOD,
                    quantization_factor=qp, resolution=(W, H))
                out.append(InputParameters(y_sweep[lane], W, H, ec,
                                           frames_to_process=SWEEP_FRAMES))
            return out

        encode_videos_batched(sweep_cells("sb"), results_csv_path=None)  # compile
        for p in sweep_cells("ss"):
            encode_video(p, results_csv_path=None)  # warm serial trees
        sweep_cf = len(SWEEP_QPS) * SWEEP_FRAMES
        tb, ts = [], []
        for _ in range(3):  # alternate the lanes rep by rep
            t0 = time.time()
            for p in sweep_cells("ss"):
                encode_video(p, results_csv_path=None)
            ts.append(time.time() - t0)
            t0 = time.time()
            encode_videos_batched(sweep_cells("sb"), results_csv_path=None)
            tb.append(time.time() - t0)
        sweep_fps = sweep_cf / min(tb)
        sweep_fps_serial = sweep_cf / min(ts)

        print(json.dumps({
            "metric": "CIF P-frame encode throughput (full-search ME r=2, block 8, end-to-end)",
            "value": round(fps, 2),
            "unit": "frames/sec",
            "vs_baseline": round(fps / BASELINE_FPS, 1),
            "median": round(median_fps, 2),
            "median_vs_baseline": round(median_fps / BASELINE_FPS, 1),
            "reps": len(times),
            "deliverable_fps": round(deliverable_fps, 2),
            "deliverable_vs_baseline": round(
                deliverable_fps / DELIVERABLE_BASELINE_FPS, 1),
            "deliverable_reps": len(d_times),
            "sweep_fps_aggregate": round(sweep_fps, 2),
            "sweep_fps_serial": round(sweep_fps_serial, 2),
            "sweep_speedup": round(sweep_fps / sweep_fps_serial, 2),
            "device": device,
        }))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
