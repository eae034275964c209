"""Multi-chip RC 2/3 encode: a speculative GOP pipeline.

Reference RC modes 2/3 carry exactly ONE scalar across GOP boundaries: the
previous frame's average row QP (``int(mean(rows) - 0.1) + 1``, reference
IFrame.py:35), which seeds the next frame's constant-QP first pass.  Every
other piece of state resets at a GOP start — the I-frame rebuilds the
reference stack from scratch (models/two_pass.py ``first_is_intra`` ignores
the incoming stack entirely) — so GOP g's whole device program is a pure
function of (its frames, one int32 seed).

This module runs whole GOPs one-per-device, *speculatively*:

* each GOP dispatches immediately to its device with a PREDICTED seed: the
  newest landed exit scalar among in-flight GOPs (polled non-blockingly —
  the 4-byte copies start at dispatch), else the last drained realized
  average, else the RC-table/budget fixed point (the lowest table QP whose
  'I' row bits fit an equal-share row budget — the value the second pass
  converges to, reference RateControl.py:34-43);
* when spare devices exist, the GOP ALSO dispatches with a second seed one
  step in the last observed drift direction (default +1: the exit carry
  ``int(mean(rows)-0.1)+1`` truncates upward as soon as two rows pick one
  QP higher), so either variant can be promoted at drain time
  (``BVC_DUAL_SEED=0`` disables);
* when GOP g-1's realized scalar lands (a 4-byte async fetch) the
  prediction is checked.  Hit: the outputs are exact — the program is the
  identical serial two-pass chunk program
  (models/two_pass.encode_chunk_two_pass), so same inputs give the same
  bits.  Miss: the GOP re-dispatches with the corrected seed before any of
  its artifacts are consumed;
* artifacts are fetched, finalized and written strictly in GOP order, and
  only after the GOP's seed is confirmed — so the artifact tree is
  byte-identical to a serial run in every case (tests/test_parallel.py
  asserts this for RC2 and RC3).

The average row QP converges to the table QP that fits the per-frame budget
and is then constant on steady content, so the predictor hits almost
always; a scene cut costs at most one re-dispatch of one GOP.  On hits all
devices compute concurrently; the serial chain only re-appears on misses.
This design replaces the reference's inherently serial two-pass loop
(reference encoder.py:85-98) with speculation across devices instead of trying
to translate it.
"""

import os
import time
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import pack as PK
from ..rc.rate_control import bit_budget_per_frame
from ..utils.frame_utils import pad_frame, padded_dims
from ..utils.logger import get_logger

logger = get_logger()


class _GopRec:
    __slots__ = ("g", "dev_idx", "seed", "confirmed", "chunks", "avg_out",
                 "inputs", "dispatch_dt", "n_frames", "pred", "alt")

    def __init__(self, g):
        self.g = g
        self.dev_idx = None
        self.chunks = []   # [(indices, frames_np, dev_out)]
        self.inputs = []   # [(indices, frames_np, ubuf, pshape, first_is_intra)]
        self.dispatch_dt = 0.0
        self.n_frames = 0
        self.pred = None   # the speculative seed this GOP first dispatched with
        self.alt = None    # (dev_idx, seed, chunks, avg_out) second-seed run


def run_two_pass_sharded(params, ec, f_in, tbl_np, write_out):
    """Drive the speculative GOP pipeline for ``encode_video``.  Interface
    mirrors models.pipeline._run_chunked: reads frames from ``f_in``, hands
    finalized-frame futures to ``write_out`` in frame order."""
    from concurrent.futures import ThreadPoolExecutor

    from ..models.pipeline import (INTER, MAX_CHUNK, _acct, _finalize_compact,
                                   _prev_avg_qp, _rebuild_frame, _stage,
                                   _two_pass_seed_scalars, shard_device_count)
    from ..models.two_pass import encode_chunk_two_pass

    bs = ec.block_size
    y_size = params.width * params.height
    pw, ph = padded_dims(params.width, params.height, bs)
    nbr_total = ec.resolution[1] // bs
    frac = ec.fracMeEnabled
    fast = ec.fastME
    exact = getattr(ec, "exact_transform", False)
    R = ec.nRefFrames
    sr = max(ec.search_range, 0)
    I = ec.I_Period
    N = params.frames_to_process

    # transport statics — identical to the serial two-pass path
    # (models/pipeline._run_chunked), minus tail mode: the per-GOP fetch is
    # one cap-padded buffer per chunk, like parallel/gop.py
    int8q = PK.qdct_int8_safe(ec)
    mv8 = PK.mv_int8_safe(ec)
    q4 = PK.qdct_nibble_safe(ec)
    qfrac = PK.qcap_fraction(ec)
    vbytes = 1 if int8q else 2
    mvk = 3 if R > 1 else 2
    layout = PK.FrameLayout(ph, pw, bs, vbytes, True, True, mv8, q4, False,
                            tail=False, mvk=mvk, mvn=PK.mv_nibble_safe(ec),
                            qfrac=qfrac)
    qcap, qecap, ecap, jkcap, q4cap = (layout.capq, layout.capqe, layout.cape,
                                       layout.capk, layout.capq4)
    upack = os.environ.get("BVC_UPACK", "1") != "0"
    ucap = PK.input_esc_cap(ph, pw)

    # shared scene-change statistic derivation (byte-parity-critical across
    # the serial / batch / sharded lanes)
    exp_p, _ = _two_pass_seed_scalars(ec, bs)

    D = shard_device_count(ec)
    devices = jax.devices()[:D]

    # per-device constants (a jit program's args must share one device)
    gray = np.full((ph, pw), 128, np.uint8)
    refs0_np = np.zeros((R, ph, pw), np.uint8)
    refs0_np[0] = 128
    hps0_np = np.zeros((R, 2 * ph, 2 * pw), np.uint8)
    if frac:
        from ..ops.interp import build_half_pel

        hps0_np[0] = np.asarray(build_half_pel(jnp.asarray(gray)))
    consts = []
    for d in devices:
        put = lambda x: jax.device_put(x, d)  # noqa: E731
        consts.append(dict(
            refs0=put(refs0_np), hps0=put(hps0_np), nv0=put(np.int32(1)),
            budget=put(np.float32(bit_budget_per_frame(ec))),
            tbl0=put(tbl_np[0]), tbl1=put(tbl_np[1]),
            exp_p=put(np.float32(exp_p)),
            iqp=put(np.int32(ec.quantization_factor)),
        ))

    fin_pool = ThreadPoolExecutor(max_workers=4)
    inflight: deque = deque()
    free_devs: deque = deque(range(D))
    overflow_frames = [0]
    miss_count = [0]
    alt_hits = [0]
    seed_trace = []  # (gop, predicted seed, true seed) for speculative GOPs
    dual = D > 1 and os.environ.get("BVC_DUAL_SEED", "1") != "0"

    # Cold-start prediction from the same RC-table/budget math the device
    # runs (reference RateControl.py:34-43 with the always-'I' quirk,
    # Frame.py:169): the converged second-pass row QP is the lowest table QP
    # whose expected 'I' row bits fit an equal-share per-row budget.  The
    # GOP-exit carry ``int(mean(rows) - 0.1) + 1`` (IFrame.py:35) then lands
    # on that QP (uniform rows) or one above (>=2 rows one QP higher tip the
    # truncation) — the dual-seed dispatch below covers both.
    qps_np, bits_np = np.asarray(tbl_np[0]), np.asarray(tbl_np[1])
    row_budget = bit_budget_per_frame(ec) / max(nbr_total, 1)
    _fit = np.nonzero(bits_np <= row_budget)[0]
    qp_star = int(qps_np[_fit[0]] if _fit.size else qps_np[-1])
    qp_lo, qp_hi = int(qps_np[0]), int(qps_np[-1])

    seed0 = int(_prev_avg_qp([ec.quantization_factor], ec))
    chain_avg = [seed0]    # realized average entering the next undrained GOP
    next_pred = [qp_star]  # predictor for speculative dispatches
    last_drift = [1]       # direction of the last exit-vs-entry change

    def _run_gop(rec: _GopRec, dev_idx: int, seed: int):
        """Run every chunk of one GOP on one device, chained on-device within
        the GOP; the artifact buffers and the final average-QP scalar start
        their d2h copies immediately (speculative prefetch).  Returns
        ``(chunks, avg_out)``."""
        t0 = time.time()
        c = consts[dev_idx]
        d = devices[dev_idx]
        ref, hp, nv = c["refs0"], c["hps0"], c["nv0"]
        prev = jax.device_put(np.int32(seed), d)
        chunks = []
        for indices, frames_np, ubuf, pshape, fii in rec.inputs:
            with _stage("dispatch: h2d asarray"):
                fr = jax.device_put(ubuf if ubuf is not None else frames_np, d)
            _acct("h2d MB", fr.nbytes)
            dev, ref, hp, nv, prev = encode_chunk_two_pass(
                fr, ref, hp, nv, prev, c["budget"], c["tbl0"], c["tbl1"],
                c["exp_p"], c["iqp"], bs, sr, fast, frac, fii, exact=exact,
                compact=True, int8q=int8q, mv8=mv8, q4=q4, tail=False,
                packed_shape=pshape, qfrac=qfrac)
            dev[4].copy_to_host_async()
            chunks.append((indices, frames_np, dev))
        prev.copy_to_host_async()
        rec.dispatch_dt += time.time() - t0
        return chunks, prev

    def _refresh_pred():
        """Non-blocking predictor refresh: the newest in-flight GOP whose exit
        scalar has already landed is a better guess than the last drained one
        (exact whenever that GOP's own entry seed was right — the common
        case).  Never waits; worst case the previous prediction stands."""
        for r in reversed(inflight):
            if r.avg_out.is_ready():
                next_pred[0] = int(jax.device_get(r.avg_out))
                return

    def drain_one():
        rec = inflight.popleft()
        if not rec.confirmed:
            # chain_avg now holds GOP g-1's realized average (set when it
            # drained); a mispredicted GOP re-runs with the true seed unless
            # its dual-seed twin already ran with it
            true_seed = chain_avg[0]
            seed_trace.append((rec.g, rec.pred, true_seed))
            if rec.seed != true_seed:
                if rec.alt is not None and rec.alt[1] == true_seed:
                    alt_hits[0] += 1
                    rec.alt, (rec.dev_idx, rec.seed, rec.chunks, rec.avg_out) = (
                        (rec.dev_idx, rec.seed, rec.chunks, rec.avg_out), rec.alt)
                else:
                    miss_count[0] += 1
                    rec.chunks, rec.avg_out = _run_gop(rec, rec.dev_idx, true_seed)
                    rec.seed = true_seed
            rec.confirmed = True
        per_frame_dt = rec.dispatch_dt / max(rec.n_frames, 1)
        hist: deque = deque([gray], maxlen=R)
        for indices, frames_np, dev in rec.chunks:
            with _stage("fetch (device_get)"):
                packed = jax.device_get(dev[4])  # [k, layout.total]
            _acct("d2h MB", packed.nbytes)
            for k in range(len(indices)):
                f = layout.split(packed[k])
                with _stage("overflow fallback fetch"):
                    jover = f["jn"] > jkcap
                    q_full = (jax.device_get(dev[2][k])
                              if f["qt"] > qcap or f["qn"] > qecap
                              or f["qn4"] > q4cap else None)
                    a_full = (jax.device_get(dev[1][k])
                              if int(f["meta"][0]) == INTER
                              and (f["an"] > ecap or jover) else None)
                    r_full = (jax.device_get(dev[0][k])
                              if f["rn"] > ecap or jover else None)
                if q_full is not None or a_full is not None or r_full is not None:
                    overflow_frames[0] += 1
                rebuilt = _rebuild_frame(f, ec, hist, q_full, r_full, a_full)
                fut = fin_pool.submit(_finalize_compact, indices[k],
                                      frames_np[k], f, ec, rebuilt, a_full)
                write_out(fut, per_frame_dt)
        realized = int(jax.device_get(rec.avg_out))
        if realized != chain_avg[0]:
            last_drift[0] = 1 if realized > chain_avg[0] else -1
        chain_avg[0] = realized
        next_pred[0] = realized
        free_devs.append(rec.dev_idx)
        if rec.alt is not None:
            free_devs.append(rec.alt[0])
            rec.alt = None

    n_read = 0
    truncated_tail = 0
    g = 0
    try:
        while n_read < N:
            # read one whole GOP (<= I_Period frames), split into chunks
            rec = _GopRec(g)
            gop_len = min(I, N - n_read)
            got = 0
            while got < gop_len:
                k = min(MAX_CHUNK, gop_len - got)
                raw = f_in.read(y_size * k)
                n = len(raw) // y_size
                truncated_tail = len(raw) % y_size
                if n == 0:
                    break
                with _stage("prep: pad+stack"):
                    frames_np = np.stack([
                        pad_frame(np.frombuffer(
                            raw[i * y_size : (i + 1) * y_size], np.uint8
                        ).reshape(params.height, params.width), bs)
                        for i in range(n)
                    ])
                ubuf = pshape = None
                if upack:
                    from ..entropy.native import pack_input_frames

                    with _stage("prep: input pack"):
                        ubuf = pack_input_frames(frames_np, ucap)
                    if ubuf is not None:
                        pshape = (n, ph, pw)
                indices = list(range(n_read + got + 1, n_read + got + n + 1))
                rec.inputs.append((indices, frames_np, ubuf, pshape, got == 0))
                got += n
                if truncated_tail or n < k:
                    break
            if got == 0:
                break
            rec.n_frames = got
            while not free_devs:
                drain_one()
            rec.dev_idx = free_devs.popleft()
            if not inflight:
                # every prior GOP drained: the chain value is exact
                rec.confirmed = True
                rec.seed = chain_avg[0]
                rec.chunks, rec.avg_out = _run_gop(rec, rec.dev_idx, rec.seed)
            else:
                _refresh_pred()
                rec.confirmed = False
                rec.pred = rec.seed = next_pred[0]
                rec.chunks, rec.avg_out = _run_gop(rec, rec.dev_idx, rec.seed)
                alt_seed = min(max(rec.seed + last_drift[0], qp_lo), qp_hi)
                if dual and alt_seed != rec.seed and free_devs:
                    alt_dev = free_devs.popleft()
                    alt_chunks, alt_avg = _run_gop(rec, alt_dev, alt_seed)
                    rec.alt = (alt_dev, alt_seed, alt_chunks, alt_avg)
            inflight.append(rec)
            n_read += got
            g += 1
            if truncated_tail or got < gop_len:
                break
        while inflight:
            drain_one()
        if truncated_tail:
            raise ValueError(
                f"truncated frame: read {truncated_tail} of {y_size} bytes")
    finally:
        fin_pool.shutdown(wait=True)
        from ..models import pipeline as _pl

        _pl.LAST_RUN_STATS.clear()
        _pl.LAST_RUN_STATS.update(overflow_frames=overflow_frames[0],
                                  frames=n_read, rc_seed_misses=miss_count[0],
                                  gops=g, devices=D,
                                  rc_seed_trace=seed_trace,
                                  rc_alt_hits=alt_hits[0])
        if n_read and overflow_frames[0] > max(n_read // 50, 2):
            logger.warning(
                f"compact-transfer overflow on {overflow_frames[0]}/{n_read} "
                f"frames (sharded RC path)")
        if miss_count[0] or alt_hits[0]:
            logger.info(
                f"speculative RC pipeline: {miss_count[0]}/{g} GOP seed "
                f"mispredictions (each cost one re-dispatch), "
                f"{alt_hits[0]} dual-seed saves")
