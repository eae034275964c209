"""Device encode/decode drivers.

The encode loop is an **async GOP-chunked pipeline**: one jitted device
program encodes a whole GOP segment (models/chunk.py; RC 2/3 use the fused
on-device two-pass program, models/two_pass.py; nRefFrames > 1 carries a
rolling reference stack through the scan in either), so the host touches
the device once per GOP.  JAX dispatch is asynchronous and the inter-frame
dependency (reference frames) lives entirely on device, so the device chews
through the frame chain while the host runs entropy coding for earlier
chunks, and a synchronous round trip per frame is never paid.

Output artifacts, bitstream framing, metrics rows and RC decisions are
identical to the golden model / reference (see golden/encoder.py for the
framing spec); the only permitted divergence is the documented float32-DCT
rounding edge (ops/transform.py).
"""

import csv
import os
import time
from collections import deque
from statistics import mean

import jax
import jax.numpy as jnp
import numpy as np

from ..config import InputParameters
from ..entropy import EOB_MARKER
from ..entropy.native import (
    decode_dct_scans,
    decode_symbols_np,
    encode_dct_plane_bytes,
    encode_symbols_bytes,
    format_mv_lines,
)
from ..entropy.zigzag import zigzag_indices
from ..golden.encoder import SCENE_CHANGE_THRESHOLD, _append_throughput, _load_rc_table
from ..io.fileio import FileIOHelper, overwrite_open, write_y_only_frame
from ..metrics.frame_metrics import FrameMetrics
from ..ops.interp import build_half_pel
from ..ops.intra import intra_decode_frame, intra_encode_frame
from ..rc.rate_control import bit_budget_per_frame, find_rc_qp_for_row
from ..utils.frame_utils import pad_frame, padded_dims, psnr
from ..utils.logger import get_logger
from .pframe import pframe_decode, pframe_encode

logger = get_logger()

INTER, INTRA = 0, 1
# BVC_PROFILE=1: accumulate a host-side stage breakdown (dispatch / fetch /
# finalize / write) into STAGE_TIMER and log it at the end of every encode
# (utils/profiling.Timer).
_PROFILE = os.environ.get("BVC_PROFILE", "0") != "0"
if _PROFILE:
    from ..utils.profiling import Timer

    STAGE_TIMER = Timer()
else:
    STAGE_TIMER = None


def _stage(name):
    import contextlib

    return STAGE_TIMER(name) if STAGE_TIMER is not None else contextlib.nullcontext()


def _acct(name, nbytes):
    """Transfer-byte accounting under BVC_PROFILE: the 'total' column of rows
    named '... MB' is megabytes, not seconds."""
    if STAGE_TIMER is not None and nbytes:
        STAGE_TIMER.totals[name] += nbytes / 1e6
        STAGE_TIMER.counts[name] += 1



def _table_arrays(ec):
    """RC lookup as device arrays (ascending QP; always the 'I' column — the
    reference prices every row with the I table, Frame.py:169)."""
    table = ec.rc_lookup_table
    if not table:
        return np.zeros(1, np.int32), np.zeros(1, np.float32)
    qps = np.asarray(sorted(table.keys()), dtype=np.int32)
    bits = np.asarray([table[int(q)]["I"] for q in qps], dtype=np.float32)
    return qps, bits


def _two_pass_seed_scalars(ec, bs):
    """Host scalars seeding the fused two-pass program, shared by the
    serial pipeline and the batch lane (their derivations must stay
    identical for batched-vs-serial byte parity): the scene-change
    statistic ``exp_p`` and the pass-1 QP seed.  The expected frame size
    uses UNPADDED rows like the reference (Frame.py:158 sizes it from
    ec.resolution) and the golden oracle — identical at block
    multiples."""
    nbr_total = ec.resolution[1] // bs
    try:
        exp_p = float(ec.rc_lookup_table[ec.quantization_factor]["P"]
                      * nbr_total)
    except (KeyError, TypeError):
        exp_p = float("inf")  # overage undefined -> never a scene change
    return exp_p, _prev_avg_qp([ec.quantization_factor], ec)


def _prev_avg_qp(prev_rows, ec):
    """``int(mean(prev.rc_qp_per_row) - 0.1) + 1`` (reference IFrame.py:35)
    with the non-strict fallback for empty history."""
    rows = prev_rows or None
    if rows is None:
        if getattr(ec, "strict_reference_crashes", False):
            mean([])  # StatisticsError, like the reference
        rows = [ec.quantization_factor]
    return int(mean(rows) - 0.1) + 1




class _Finalized:
    __slots__ = (
        "index", "mode", "curr", "recon", "qdct", "res_w_mc", "res_wo_mc",
        "mv_line", "pred_bytes", "pred_bits", "dct_bytes", "dct_bits",
        "avg_mae", "comparisons", "rc_qp_per_row", "bits_per_row", "host_dt",
        "psnr",
    )

    def is_iframe(self):
        return self.mode == INTRA


def _wrap_diff_u8(curr, prev_recon):
    """res_wo_mc plane: curr minus reference, int16 stored as int8 bit pattern
    (reference PFrame.py:103,116 with the int8-plane wrap quirk)."""
    from ..entropy import native

    lib = native._load()
    if lib is not None:
        c = np.ascontiguousarray(curr, np.uint8)
        p = np.ascontiguousarray(prev_recon, np.uint8)
        out = np.empty_like(c)
        lib.bvc_wrap_diff(c.ctypes.data, p.ctypes.data, out.ctypes.data, c.size)
        return out
    diff = curr.astype(np.int16) - prev_recon.astype(np.int16)
    return (diff % 256).astype(np.uint8)



def _host_entropy(mode, aux, row_qps, qdct, ec, nbr, nbc, bs):
    """Host entropy coder: vectorized symbol prep + native bit packing ->
    ``(pred_bytes, pred_bits, dct_bytes, dct_bits)``.  The non-devbits
    finalize path, and the sampled devbits cross-check."""
    qp_diffs = row_qps.astype(np.int64) - ec.quantization_factor
    if mode == INTRA:
        syms = np.hstack([qp_diffs[:, None], aux.astype(np.int64)]).ravel()
    else:
        k = 3 if ec.nRefFrames > 1 else 2
        flat = aux.reshape(-1, 3).astype(np.int64)
        prev = np.vstack([np.zeros(3, np.int64), flat[:-1]])
        diffs = (flat - prev)[:, :k].reshape(nbr, nbc * k)
        syms = np.hstack([qp_diffs[:, None], diffs]).ravel()
    pred_bytes, pred_bits = encode_symbols_bytes(syms)
    dct_bytes, dct_bits = encode_dct_plane_bytes(
        qdct, bs, zigzag_indices(bs), EOB_MARKER)
    return pred_bytes, pred_bits, dct_bytes, dct_bits


def _finalize_fields(index, mode, curr, recon, art, qdct, aux, metric_sum,
                     comparisons, row_qps, row_bits, ec, prev_recon=None,
                     want_psnr=True, dev_streams=None) -> _Finalized:
    """Entropy-pack one frame from host-resident fields.  ``aux`` is the
    intra-mode grid [nbr, nbc] (INTRA) or the MV field [nbr, nbc, 3] (INTER);
    ``metric_sum`` the summed per-block MAE numerators.  When the previous
    frame's reconstruction is supplied, the res_wo_mc artifact and PSNR are
    computed here (on the worker pool) instead of on the serial writer."""
    t0 = time.time()
    bs = ec.block_size
    f = _Finalized()
    f.index, f.mode, f.curr = index, mode, curr
    # skipped for throwaway first passes (their PSNR is never read)
    f.psnr = psnr(curr, recon) if want_psnr else None
    h, w = qdct.shape
    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc
    f.recon = recon
    f.comparisons = int(comparisons)
    f.avg_mae = float(metric_sum) / (bs * bs) / nb
    if mode == INTRA:
        f.res_w_mc = art
        f.res_wo_mc = art
        f.mv_line = "\n"
    else:
        # res_wo_mc = curr minus the OLDEST reference (PFrame.py:103,116):
        # computable here for the single-reference chunked paths, otherwise
        # left for the in-order writer and its reference-history deque
        f.res_w_mc = art
        if prev_recon is not None:
            f.res_wo_mc = _wrap_diff_u8(curr, prev_recon)
        else:
            f.res_wo_mc = None  # filled by the in-order writer
        f.mv_line = format_mv_lines(aux, bs)
    f.qdct = qdct
    f.rc_qp_per_row = row_qps.tolist() if ec.RCflag else []
    f.bits_per_row = row_bits.tolist()

    if dev_streams is not None:
        # devbits: the device already packed the final bitstreams
        # (ops/bitpack.py); the bytes land here byte-identical to the host
        # coder (tests/test_bitpack.py + the golden e2e parity suite)
        f.pred_bytes, f.pred_bits, f.dct_bytes, f.dct_bits = dev_streams
        # In devbits mode the row-bits assert below compares two DEVICE
        # derivations (bitpack vs bitlen), so the host coder drops out of
        # the runtime invariant.  Re-encode a sampled subset of frames
        # through the host coder and require byte identity, keeping the
        # "device bits == host entropy coder bits" invariant live end to
        # end without paying the host pack on every frame.
        # (index - 1): frame indices are 1-based, so the FIRST devbits frame
        # of every run is always cross-checked — batch-lane cells are
        # typically 10-24 frames, which a % on the raw index would skip
        # entirely at the default interval
        if _DEVBITS_CHECK and (index - 1) % _DEVBITS_CHECK == 0:
            hp_bytes, hp_bits, hd_bytes, hd_bits = _host_entropy(
                mode, aux, row_qps, qdct, ec, nbr, nbc, bs)
            assert (hp_bits == f.pred_bits and hd_bits == f.dct_bits
                    and hp_bytes == f.pred_bytes and hd_bytes == f.dct_bytes), (
                f"devbits stream diverged from host entropy coder at frame "
                f"{index}")
    else:
        # entropy finalization (vectorized symbol prep + native bit packing)
        f.pred_bytes, f.pred_bits, f.dct_bytes, f.dct_bits = _host_entropy(
            mode, aux, row_qps, qdct, ec, nbr, nbc, bs)

    assert f.dct_bits + f.pred_bits == sum(f.bits_per_row), (
        "device bit pricing diverged from host entropy coder"
    )
    f.host_dt = time.time() - t0
    return f


def _finalize_arrays(index, mode, curr, recon, art, qdct, smalls, ec,
                     prev_recon=None, want_psnr=True) -> _Finalized:
    """Finalize from the full device smalls vector (non-compact chunk
    paths): intra smalls = (modes, maes, row_qps,
    row_bits), inter smalls = (mvs, sads, comps, row_qps, row_bits)."""
    bs = ec.block_size
    h, w = qdct.shape
    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc
    if mode == INTRA:
        aux = smalls[:nb].reshape(nbr, nbc)
        metric_sum = smalls[nb : 2 * nb].astype(np.float64).sum()
        comparisons = 2 * nb  # reference params.py:63
        row_qps, row_bits = smalls[2 * nb : 2 * nb + nbr], smalls[2 * nb + nbr :]
    else:
        aux = smalls[: 3 * nb].reshape(nbr, nbc, 3)
        metric_sum = smalls[3 * nb : 4 * nb].astype(np.float64).sum()
        comparisons = smalls[4 * nb : 5 * nb].astype(np.int64).sum()
        row_qps, row_bits = smalls[5 * nb : 5 * nb + nbr], smalls[5 * nb + nbr :]
    return _finalize_fields(index, mode, curr, recon, art, qdct, aux,
                            metric_sum, comparisons, row_qps, row_bits, ec,
                            prev_recon=prev_recon, want_psnr=want_psnr)


_HP_CACHE: dict = {}  # id(recon) -> (recon, halfpel): reconstructions sit in
# the host reference mirror for up to nRefFrames frames, so their (2H x 2W)
# interpolations are reused across finalizes instead of recomputed per frame


def _host_halfpel(recon):
    from ..golden.interp import build_pre_interpolated_buffer

    hit = _HP_CACHE.get(id(recon))
    if hit is not None and hit[0] is recon:
        return hit[1]
    hp = build_pre_interpolated_buffer(recon)
    if len(_HP_CACHE) > 16:
        _HP_CACHE.clear()
    _HP_CACHE[id(recon)] = (recon, hp)
    return hp


def _rebuild_prepare(f, ec, q_full=None):
    """Frame-INDEPENDENT half of the compact-path host rebuild, safe to run
    concurrently across frames on the finalize pool: qdct unpack, the
    integer-exact IDCT, the art guess.  Returns (mode, qdct, row_qps, x,
    art_guess)."""
    from ..ops import pack as PK

    bs = ec.block_size
    h, w = f["h"], f["w"]
    nbr = h // bs
    mode = int(f["meta"][0])
    row_qps = np.asarray(f["meta"][3 : 3 + nbr], np.int32)
    if q_full is not None:
        qdct = np.asarray(q_full, dtype=np.int16)
    elif f["lay"].devbits:
        qdct = PK.decode_qdct_devbits(f, bs)
    else:
        qdct = PK.unpack_qdct(PK.qv_of(f), f["ql"], h, w, bs,
                              zigzag_indices(bs))
    x, art_guess = PK.host_x_art(qdct, row_qps, bs, want_art=mode == INTER)
    return mode, qdct, row_qps, x, art_guess


def _rebuild_apply(prep, f, ec, hist, r_full=None):
    """Reference-CHAINED half of the rebuild: MC prediction from the host
    history, the recon guess, correction-code application, history update.
    Runs strictly in frame order — frame k's reconstruction predicts frame
    k+1 — on the rebuild chain worker (or the fetch loop for the sharded
    path).  Returns the host-resident fields the (parallel) finalize step
    needs: (mode, recon, qdct, pred, oldest, art_guess, art) — ``art`` is
    None here (the staged path leaves the art codes to the finalize pool;
    :func:`_rebuild_fused` fills it)."""
    from ..ops import pack as PK

    if hasattr(prep, "result"):
        prep = prep.result()
    mode, qdct, row_qps, x, art_guess = prep
    bs = ec.block_size
    h, w = f["h"], f["w"]
    nbr, nbc = h // bs, w // bs
    if mode == INTRA:
        hist.clear()
        pred = oldest = None
        if r_full is not None:
            recon = np.asarray(r_full)
        else:
            modes = f["modes"][: nbr * nbc].reshape(nbr, nbc).astype(np.int32)
            recon = PK.host_rebuild_intra_recon(qdct, modes, row_qps,
                                                f["rc"], f["re"], bs,
                                                jst=PK.joint_states_of(f),
                                                x=x)
    else:
        refs = np.stack(hist)  # oldest first (reference deque semantics)
        mvs = f["mv"].astype(np.int32).reshape(nbr, nbc, 3)
        hps = (np.stack([_host_halfpel(r) for r in hist])
               if ec.fracMeEnabled else None)
        pred = PK.host_pred_inter(refs, mvs, bs, ec.fracMeEnabled, hps)
        oldest = hist[0]
        jst = PK.joint_states_of(f)
        if r_full is not None:
            recon = np.asarray(r_full)
        elif jst is not None:
            recon = PK.host_recon_joint(x, pred, jst, f["re"], bs)
        else:
            recon = PK.unpack_vs_base(
                f["rc"], f["re"], PK.host_recon_guess_from_x(x, pred, bs))
    hist.append(recon)
    return mode, recon, qdct, pred, oldest, art_guess, None


def _rebuild_fused(f, ec, hist):
    """ONE native call for an inter frame's whole host rebuild
    (ops/pack.host_rebuild_p -> native bvc_rebuild_p), including the art
    correction codes the staged path leaves to the finalize pool.  Falls
    back to the staged chain when the native library is unavailable."""
    from ..ops import pack as PK

    bs = ec.block_size
    h, w = f["h"], f["w"]
    nbr, nbc = h // bs, w // bs
    if ec.fracMeEnabled:
        planes = (np.stack([_host_halfpel(r) for r in hist])
                  if len(hist) > 1 else _host_halfpel(hist[0])[None])
    else:
        planes = np.stack(hist) if len(hist) > 1 else hist[0][None]
    mvs = f["mv"].astype(np.int32).reshape(nbr, nbc, 3)
    row_qps = np.asarray(f["meta"][3 : 3 + nbr], np.int32)
    out = PK.host_rebuild_p(f, row_qps, bs, planes, mvs, ec.fracMeEnabled)
    if out is None:
        return _rebuild_apply(_rebuild_prepare(f, ec), f, ec, hist)
    qdct, recon, art = out
    oldest = hist[0]
    hist.append(recon)
    return INTER, recon, qdct, None, oldest, None, art


def _can_fuse_rebuild(f, q_full, r_full, a_full) -> bool:
    """The fused rebuild handles exactly the no-overflow inter-frame case
    with joint art codes; every overflow/full-plane variant — and hosts
    without the native library — stays on the staged chain.  This predicate
    is the ONE dispatch decision; both call sites (_ReconRebuilder.submit
    async, _rebuild_frame sync) must stay trivial wrappers around it."""
    from ..entropy import native

    return (q_full is None and r_full is None and a_full is None
            and int(f["meta"][0]) == INTER and f.get("jb") is not None
            and native.available())


def _rebuild_frame(f, ec, hist, q_full=None, r_full=None, a_full=None):
    """Synchronous rebuild (the sharded fetch loop)."""
    if _can_fuse_rebuild(f, q_full, r_full, a_full):
        return _rebuild_fused(f, ec, hist)
    return _rebuild_apply(_rebuild_prepare(f, ec, q_full), f, ec, hist,
                          r_full)


class _ReconRebuilder:
    """Rebuild scheduler: the frame-independent prepare fans out on the
    (shared) finalize pool; only the reference-chained apply runs on the
    single ordered worker.  This cut the serial host chain from ~5 ms to
    ~2 ms per CIF block-8 frame — it was the end-to-end critical path once
    transfers shrank and the Pallas walk removed the device bottleneck."""

    def __init__(self, ec, h, w, prep_pool, pool=None):
        """``pool``: optionally share ONE ordered worker across rebuilders
        (the batch lane runs C configs on a one-core host — C private
        workers just thrash the GIL; per-config rebuild order is preserved
        because each config's frames are submitted in order)."""
        from concurrent.futures import ThreadPoolExecutor

        self.ec = ec
        self._own_pool = pool is None
        self.pool = pool if pool is not None else ThreadPoolExecutor(max_workers=1)
        self.prep_pool = prep_pool
        self.hist: deque = deque([np.full((h, w), 128, np.uint8)],
                                 maxlen=ec.nRefFrames)

    def submit(self, f, q_full=None, r_full=None, a_full=None):
        if _can_fuse_rebuild(f, q_full, r_full, a_full):
            # inter, no overflow: one native call on the ordered worker
            # (bvc_rebuild_p) — on this one-core host splitting prepare off
            # buys nothing, and the fused call skips the Python glue
            return self.pool.submit(_rebuild_fused, f, self.ec, self.hist)
        prep = self.prep_pool.submit(_rebuild_prepare, f, self.ec, q_full)
        return self.pool.submit(_rebuild_apply, prep, f, self.ec, self.hist,
                                r_full)

    def shutdown(self):
        if self._own_pool:
            self.pool.shutdown(wait=True)


def _finalize_compact(index, curr, f, ec, rebuilt, a_full=None) -> _Finalized:
    """Finalize one frame from its packed-transfer fields plus the rebuild
    stage's output (``rebuilt`` is a Future from :class:`_ReconRebuilder`
    or an already-resolved tuple).  ``a_full`` carries the full res plane
    for the rare escape-overflow fallback."""
    from ..ops import pack as PK

    if hasattr(rebuilt, "result"):
        rebuilt = rebuilt.result()
    mode, recon, qdct, pred, oldest, art_guess, art = rebuilt
    bs = ec.block_size
    h, w = recon.shape
    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc
    meta = f["meta"]
    metric_sum, comparisons = int(meta[1]), int(meta[2])
    row_qps, row_bits = meta[3 : 3 + nbr], meta[3 + nbr :]
    if mode == INTRA:
        aux = f["modes"][:nb].reshape(nbr, nbc).astype(np.int32)
        art = PK.host_intra_art(curr, recon, aux, bs)
    else:
        aux = f["mv"].astype(np.int32).reshape(nbr, nbc, 3)
        if a_full is not None:
            art = np.asarray(a_full)
        elif art is None:  # staged chain: apply the art codes here
            art = PK.joint_art(PK.joint_states_of(f), f["ae"],
                               art_guess.astype(np.int32))
    dev_streams = None
    if f["lay"].devbits and PK.devbits_ok(f):
        dev_streams = (f["pb"].tobytes(), f["pbits"],
                       f["db"].tobytes(), f["dbits"])
    return _finalize_fields(index, mode, curr, recon, art, qdct, aux,
                            metric_sum, comparisons, row_qps, row_bits, ec,
                            prev_recon=oldest, dev_streams=dev_streams)


class _EncodeSink:
    """Per-run artifact writer: the seven output files, metrics rows, the
    host mirror of the reference deque (for res_wo_mc: curr minus OLDEST
    reference, reference PFrame.py:103,116) and the bitstream framing
    (golden/encoder.py spec).  Extracted from :func:`encode_video` so the
    batched multi-config lane (models/batch.py) writes byte-identical
    artifacts through the same code.  ``write`` must be called in frame
    order (one writer thread per pipeline)."""

    def __init__(self, params: InputParameters):
        from contextlib import ExitStack

        ec = params.encoder_config
        self.ec = ec
        file_io = FileIOHelper(params)
        # overwrite_open: "w" semantics without the truncate-at-open
        # writeback stall on just-rewritten artifact trees (io/fileio)
        self._stack = ExitStack()
        en = self._stack.enter_context
        self.mv_fh = en(overwrite_open(file_io.get_mv_file_name(), text=True))
        self.qdct_fh = en(overwrite_open(
            file_io.get_quant_dct_coff_fh_file_name()))
        self.res_w_fh = en(overwrite_open(
            file_io.get_residual_w_mc_file_name()))
        self.res_wo_fh = en(overwrite_open(
            file_io.get_residual_wo_mc_file_name()))
        self.recon_fh = en(overwrite_open(
            file_io.get_mc_reconstructed_file_name()))
        self.encoded_fh = en(overwrite_open(file_io.get_encoded_file_name()))
        metrics_fh = en(overwrite_open(
            file_io.get_metrics_csv_file_name(), text=True, newline=""))
        self.metrics_writer = csv.writer(metrics_fh)
        self.metrics_writer.writerow(FrameMetrics.get_header())
        self.start_time = time.time()
        pw0, ph0 = padded_dims(params.width, params.height, ec.block_size)
        self.recon_history: deque = deque(
            [np.full((ph0, pw0), 128, np.uint8)], maxlen=ec.nRefFrames)

    def write(self, f: _Finalized, dispatch_dt: float):
        if f.is_iframe():
            self.recon_history.clear()
        elif f.res_wo_mc is None:
            f.res_wo_mc = _wrap_diff_u8(f.curr, self.recon_history[0])
        self.recon_history.append(f.recon)
        frame_psnr = f.psnr if f.psnr is not None else psnr(f.curr, f.recon)
        encoded_fh = self.encoded_fh
        start_idx = encoded_fh.tell()
        encoded_fh.write(f.mode.to_bytes(1))
        encoded_fh.write(((f.pred_bits + 7) // 8).to_bytes(2))
        encoded_fh.write(f.pred_bytes)
        encoded_fh.write(((f.dct_bits + 7) // 8).to_bytes(3))
        encoded_fh.write(f.dct_bytes)
        frame_bytes = encoded_fh.tell() - start_idx
        self.metrics_writer.writerow(
            FrameMetrics(
                f.index, f.mode, f.avg_mae, f.comparisons, frame_psnr,
                frame_bytes, encoded_fh.tell() * 8,
                dispatch_dt + f.host_dt, time.time() - self.start_time,
            ).to_csv_row()
        )
        logger.info(
            f"{f.index:2}: {'INTRA' if f.is_iframe() else 'INTER'} "
            f" mae [{round(f.avg_mae, 2):6.2f}] psnr [{round(frame_psnr, 2):6.2f}], "
            f"size: [{frame_bytes:6}]"
        )
        write_y_only_frame(self.res_w_fh, f.res_w_mc)
        write_y_only_frame(self.res_wo_fh, f.res_wo_mc)
        write_y_only_frame(self.qdct_fh, np.asarray(f.qdct, np.int16))
        write_y_only_frame(self.recon_fh, f.recon)
        self.mv_fh.write(f.mv_line)

    def close(self):
        self._stack.close()


def encode_video(params: InputParameters, results_csv_path: str | None = "results.csv"):
    ec = params.encoder_config
    y_size = params.width * params.height
    bs = ec.block_size

    _load_rc_table(ec)
    tbl_np = _table_arrays(ec)
    tbl = (jnp.asarray(tbl_np[0]), jnp.asarray(tbl_np[1]))

    sink = _EncodeSink(params)
    start_time = sink.start_time
    with open(params.y_only_file, "rb") as f_in:

        def write_out(f: _Finalized, dispatch_dt: float):
            with _stage("write artifacts"):
                sink.write(f, dispatch_dt)

        # Artifact/bitstream writing runs on ONE dedicated worker so disk IO
        # (~0.5 MB/frame across five files) overlaps the fetch/finalize
        # loop; frames are submitted strictly in order, so the file contents
        # are identical to synchronous writes.
        from concurrent.futures import ThreadPoolExecutor

        writer = ThreadPoolExecutor(max_workers=1)
        wq: deque = deque()

        write_failed = []

        def _resolve_and_write(f, dispatch_dt: float):
            # once any frame fails to finalize, write nothing after it: the
            # artifact files must end as a clean prefix, not a stream with a
            # hole (the failing frame's original exception surfaces first —
            # wq drains FIFO)
            if write_failed:
                raise RuntimeError("skipped: an earlier frame failed")
            try:
                if hasattr(f, "result"):
                    f = f.result()  # on the writer thread, not the fetch loop
                write_out(f, dispatch_dt)
            except BaseException:
                write_failed.append(True)
                raise

        def write_async(f, dispatch_dt: float):
            """``f``: a _Finalized, or a Future of one — the writer thread
            resolves futures itself, so the fetch loop never blocks on the
            finalize pool (worth ~1.6 ms/frame of main-thread wait)."""
            while wq and wq[0].done():
                wq.popleft().result()  # surface write errors promptly
            while len(wq) >= 64:  # backpressure: bound buffered frames
                wq.popleft().result()
            wq.append(writer.submit(_resolve_and_write, f, dispatch_dt))

        try:
            pg = getattr(ec, "parallel_gops", 0)
            rc_shard_ok = (os.environ.get("BVC_COMPACT", "1") != "0"
                           and params.height * params.width * 255 < 2 ** 31)
            if pg > 1 and ec.RCflag > 1 and rc_shard_ok:
                # multi-chip RC 2/3: whole GOPs one-per-device, chained by
                # the single cross-GOP scalar (prev frame's average row QP)
                # via speculative dispatch — byte-identical to serial
                # (parallel/rc_gop.py, tests/test_parallel.py)
                from ..parallel.rc_gop import run_two_pass_sharded

                run_two_pass_sharded(params, ec, f_in, tbl_np, write_async)
            elif pg > 1 and ec.RCflag <= 1:
                # multi-chip: GOP batches sharded over the mesh's data axis
                _run_gop_sharded(params, ec, f_in, tbl, write_async)
            else:
                if pg > 1:
                    logger.warning(
                        "parallel_gops ignored: compact transport disabled "
                        "or frame too large for the sharded RC path")
                # GOP-chunked dispatch: one device program per GOP segment
                # (RC 2/3 use the fused two-pass program, models/two_pass.py;
                # nRefFrames > 1 carries a rolling reference stack through the
                # scan in every chunk variant)
                _run_chunked(params, ec, f_in, tbl, write_async)
        finally:
            try:
                while wq:
                    wq.popleft().result()
            finally:
                writer.shutdown(wait=True)
                sink.close()

    elapsed = time.time() - start_time
    _append_throughput(params, elapsed, results_csv_path)


# Observability hook: per-run transfer health, refreshed by each encode
# (tests/test_fixture_conformance.py pins the overflow rate on the CIF
# camera fixture; a rising rate means a transport cap class needs a bump).
LAST_RUN_STATS: dict = {}

# Frames per dispatched chunk, dispatched chunks in flight (device compute +
# async d2h copies) before the host blocks on a fetch, and chunks fetched
# per blocking device_get on the compact path.  All three values are
# inherited from the earlier accelerator and not yet measured on the GPU.
MAX_CHUNK = int(os.environ.get("BVC_CHUNK", "24"))
DEPTH = max(int(os.environ.get("BVC_DEPTH", "2")), 1)
FETCHB = max(int(os.environ.get("BVC_FETCHB", "1")), 1)
_TRACE = os.environ.get("BVC_TRACE", "0") != "0"  # per-chunk fetch timing
# Sampled devbits-vs-host-coder byte-identity cross-check: every Nth frame
# index (0 disables).  Keeps the entropy invariant checked against the HOST
# coder at runtime even when the device packs the final bitstreams.
_DEVBITS_CHECK = int(os.environ.get("BVC_DEVBITS_CHECK", "64"))
_trace_ts: dict = {}


def _bucket(n: int) -> int:
    """Round a tail-pool fetch length up to a coarse grid (eighth steps
    between powers of two, waste <= 12.5%) so the ``pool[:n]`` slice
    programs compile a bounded number of times."""
    if n <= 4096:
        return 4096
    p = 1 << (int(n) - 1).bit_length()
    half = p // 2
    for i in range(1, 9):
        q = half + half * i // 8
        if n <= q:
            return q
    return p


def _run_chunked(params, ec, f_in, tbl, write_out):
    """GOP-chunked encode loop (single reference frame, RC mode 0/1).

    Chunks never cross an I-frame boundary; GOPs longer than MAX_CHUNK are
    split into an I-led chunk plus P-only continuation chunks.  The host
    dispatches one program per chunk, fetches its stacked outputs once, and
    entropy-finalizes frames on a small thread pool (the native bit packer
    releases the GIL) while the device runs whole GOPs ahead; byte streams
    are written strictly in frame order.
    """
    from concurrent.futures import ThreadPoolExecutor

    from .chunk import (encode_chunk, encode_chunk_intra_only,
                        encode_chunk_mixed, encode_chunk_multiref)
    from .two_pass import encode_chunk_two_pass

    bs = ec.block_size
    y_size = params.width * params.height
    rc1 = ec.RCflag == 1
    two_pass = ec.RCflag > 1
    budget0 = jnp.float32(bit_budget_per_frame(ec)) if ec.RCflag else jnp.float32(0)
    initial_qp = jnp.int32(ec.quantization_factor)
    frac = ec.fracMeEnabled
    exact = getattr(ec, "exact_transform", False)
    if two_pass:
        exp_p, pavg0 = _two_pass_seed_scalars(ec, bs)
        exp_p_frame = jnp.float32(exp_p)
        prev_avg = jnp.int32(pavg0)

    # every plane in the pipeline lives at PADDED geometry (utils
    # padded_dims; PARITY.md divergence 6) — including the gray seeds:
    # the mixed program threads the seed through its scan carry, where an
    # unpadded shape would clash with the padded per-frame outputs
    pw, ph = padded_dims(params.width, params.height, bs)
    gray = jnp.full((ph, pw), 128, dtype=jnp.uint8)
    ref = gray
    hp = build_half_pel(gray) if frac else jnp.zeros(
        (2 * ph, 2 * pw), jnp.uint8)
    multiref = ec.nRefFrames > 1
    R = ec.nRefFrames
    intra_only_cfg = ec.I_Period == 1 and not two_pass
    # BVC_MIXED=1: multi-GOP "mixed" chunks (single reference, RC 0/1) —
    # the per-frame mode is a traced array, so one program (and ONE d2h
    # fetch) spans I-frame boundaries and chunk length stops being capped
    # at the GOP: fewer round trips per frame, at the cost of a per-step
    # lax.cond (intra vs P).  Off by default (inherited; not yet measured
    # on the GPU).  Artifacts are byte-identical either way (asserted in
    # tests/test_device_pipeline.py).
    mixed_path = (not two_pass and not multiref and not intra_only_cfg
                  and os.environ.get("BVC_MIXED", "0") != "0")
    if multiref or two_pass:
        # rolling reference stack, deque semantics: slot 0 = oldest; the
        # reference seeds the deque with one gray frame (encoder.py:33).
        # The fused two-pass program always carries a stack (R == 1 for
        # single-reference runs).
        ref = jnp.zeros((R, ph, pw), jnp.uint8).at[0].set(gray)
        hp = jnp.zeros((R, 2 * ph, 2 * pw), jnp.uint8)
        if frac:
            hp = hp.at[0].set(build_half_pel(gray))
        nv = jnp.int32(1)

    pending_dev: deque = deque()   # dispatched chunks awaiting fetch
    pending_fin: deque = deque()   # (futures, per_frame_dt) awaiting write
    fin_pool = ThreadPoolExecutor(max_workers=4)
    n_read = 0  # 0-based count of frames consumed
    # host mirror of the previous frame's reconstruction (prev-chunk carry),
    # so workers can derive res_wo_mc without the serial writer; with
    # nRefFrames > 1 a full host-side deque mirrors the reference stack
    last_recon = np.full((ph, pw), 128, np.uint8)
    recon_hist: deque = deque([last_recon], maxlen=R)

    # Compact device->host transfers (ops/pack.py): ~2 bytes/pixel instead
    # of 4.  BVC_COMPACT=0 restores full-plane fetches.  The transport
    # defaults below were chosen for the earlier accelerator's narrow
    # device->host link and are not yet measured on the GPU.
    from ..ops import pack as PK

    # The compact metric sums are device int32, so frames whose worst-case
    # SAD total could overflow (> ~8 MP) use full planes instead.
    compact_env = os.environ.get("BVC_COMPACT", "1")
    compact = (compact_env != "0"
               and params.height * params.width * 255 < 2 ** 31)
    # Compact host->device uploads too (BVC_UPACK=0 restores raw frames):
    # the left-predictor nibble pack halves the raw input planes on typical
    # content.  Chunks
    # with escape-heavy frames (noise-like content) upload raw instead.
    upack = os.environ.get("BVC_UPACK", "1") != "0"
    # tail mode: the cap-padded fields travel in a per-chunk compacted pool
    # fetched at (bucket-rounded) USED size — roughly halves the d2h bytes
    # of typical content (ops/pack.pack_tail_pool)
    tail_mode = compact and os.environ.get("BVC_TAIL", "1") != "0"
    # devbits: the device packs each frame's FINAL pred/dct exp-Golomb
    # bitstreams (ops/bitpack.py) and the q-prefix transport fields
    # disappear — the host writes the bytes straight into encoded.bin and
    # re-derives qdct by decoding them in one native pass.  The serial lane
    # defaults to q-prefix codes and the batch lane (models/batch.py) to
    # devbits (inherited choices).  BVC_DEVBITS=1/0 forces either.
    devb = tail_mode and os.environ.get("BVC_DEVBITS", "0") != "0"
    int8q = PK.qdct_int8_safe(ec)
    mv8 = PK.mv_int8_safe(ec)
    q4 = PK.qdct_nibble_safe(ec)
    qfrac = PK.qcap_fraction(ec)
    nb_pad = (ph // bs) * (pw // bs)
    jt = q4 and not rc1 and ec.RCflag == 0  # tight kind cap: fixed QP >= 5

    vbytes = 1 if int8q else 2
    mvk = 3 if ec.nRefFrames > 1 else 2  # single-ref layouts drop the ref idx
    mvn = PK.mv_nibble_safe(ec)
    layouts = {
        "intra_all": PK.FrameLayout(ph, pw, bs, vbytes, False, False,
                                    q4=q4, tail=tail_mode, qfrac=qfrac,
                                    devbits=devb),
        "intra_led": PK.FrameLayout(ph, pw, bs, vbytes, True, True, mv8, q4,
                                    jt, tail=tail_mode, mvk=mvk, mvn=mvn,
                                    qfrac=qfrac, devbits=devb),
        "p_only": PK.FrameLayout(ph, pw, bs, vbytes, True, True, mv8, q4,
                                 jt, tail=tail_mode, mvk=mvk, mvn=mvn,
                                 qfrac=qfrac, devbits=devb),
        # mode is a runtime value per frame (scene changes / GOP-position
        # intra), so every row carries both mv and art fields; intra rows
        # zero the unused ones
        "two_pass": PK.FrameLayout(ph, pw, bs, vbytes, True, True, mv8, q4,
                                   False, tail=tail_mode, mvk=mvk, mvn=mvn,
                                   qfrac=qfrac, devbits=devb),
        "mixed": PK.FrameLayout(ph, pw, bs, vbytes, True, True, mv8, q4,
                                False, tail=tail_mode, mvk=mvk, mvn=mvn,
                                qfrac=qfrac, devbits=devb),
    }

    # overflow thresholds come from the layouts themselves (tail mode:
    # qv/qe/jk caps are whole-plane, so those overflows cannot fire)
    _lay0 = layouts["p_only"]
    qcap, qecap, ecap, jkcap, q4cap = (_lay0.capq, _lay0.capqe, _lay0.cape,
                                       _lay0.capk, _lay0.capq4)

    rebuilder = _ReconRebuilder(ec, ph, pw, fin_pool) if compact else None

    # NOTE: device_get stays on the dispatch thread — concurrent transfers
    # from a second thread contend with dispatch inside the device client
    # and halve throughput (measured).  Each chunk is fetched as ONE packed
    # uint8 buffer (ops/pack.py), so per-transfer latency is paid once per
    # chunk.  Overflow-fallback
    # full planes are fetched here too, for the same reason (rare by
    # construction).
    overflow_frames = [0]  # frames that needed a full-plane fallback fetch

    def submit_compact(futures, idx, curr, f, d_qdcts, d_arts, d_recons, k=None):
        # index the device stacks lazily — slicing dispatches a device
        # program, so it must only happen on the (rare) overflow path
        sel = (lambda a: a[k]) if k is not None else (lambda a: a)
        with _stage("overflow fallback fetch"):
            jover = f["jn"] > jkcap  # kind-list overflow: states are garbage
            q_over = (not PK.devbits_ok(f) if f["lay"].devbits
                      else (f["qt"] > qcap or f["qn"] > qecap
                            or f["qn4"] > q4cap))
            q_full = jax.device_get(sel(d_qdcts)) if q_over else None
            a_full = (jax.device_get(sel(d_arts))
                      if int(f["meta"][0]) == INTER
                      and (f["an"] > ecap or jover) else None)
            r_full = (jax.device_get(sel(d_recons))
                      if f["rn"] > ecap or jover else None)
        if q_full is not None or a_full is not None or r_full is not None:
            overflow_frames[0] += 1
        reb = rebuilder.submit(f, q_full, r_full, a_full)
        futures.append(fin_pool.submit(
            _finalize_compact, idx, curr, f, ec, reb, a_full))

    # recent per-frame tail byte totals per chunk kind, for the predictive
    # prefetch: the device executes programs strictly in dispatch order, so
    # a pool slice dispatched at FETCH time queues behind every later
    # chunk's compute (~60 ms) — instead a fused heads+tail prefix sized
    # from recent totals (15% margin) is dispatched right after its own
    # chunk program, and a late exactly-sized fetch only happens on a
    # content jump (rare).  The fused buffer makes this ONE d2h wait per
    # chunk instead of two.
    tail_stats: dict = {}

    def tail_prefetch(kind, dev, n_frames):
        if not tail_mode:
            return None
        fused = dev[4]
        lay = layouts[kind]
        base = n_frames * lay.total
        hist = tail_stats.get(kind)
        if not hist:
            # first chunk of this KIND: per-frame pool bytes are mostly
            # content-driven, not kind-driven (the kinds differ by one
            # intra row), so seed from any other kind's history + 25%
            other = [max(h) for h in tail_stats.values() if h]
            if other:
                hist = [max(other) * 1.25]
        if hist:
            # 10% margin + 2 KB over the recent worst: a shortfall only
            # costs one late exactly-sized fetch (queued behind in-flight
            # chunks), so the margin stays tight
            est = int(max(hist) * n_frames * 1.10) + 2048
        else:
            # very first chunk: no estimate at all — a fifth of the cap
            # covers the measured ~15% typical pool occupancy (the caps
            # are deliberately generous; a cap-sized prefetch would move
            # ~0.5 MB per chunk), and a shortfall
            # only costs one late fetch.  devbits pool caps are ~3.5x
            # larger (worst-case bitstream buffers), so scale the divisor
            # to land at the same ~10 KB/frame initial guess.
            est = (n_frames * PK.tail_pool_cap(lay)
                   // (16 if lay.devbits else 5))
        n = min(fused.shape[0], base + _bucket(est))
        sl = fused[:n]
        sl.copy_to_host_async()
        return sl

    def parse_compact(indices, currs, kind, dev, pre):
        """Tail stage A over the FETCHED prefix bytes (``pre`` is host
        memory; fetch_chunks did the one batched d2h wait): split heads,
        derive the pool offsets from the head counts, and slice the pool
        bytes — on prediction shortfall only, a late exactly-sized fetch."""
        lay = layouts[kind]
        if not tail_mode:
            return (indices, currs, kind, dev, pre, None, None)  # pre: heads
        k = len(indices)
        base = k * lay.total
        buf = pre  # host bytes, fetched by fetch_chunks
        heads = buf[:base].reshape(k, lay.total)
        sizes = [sum(lay.tail_sizes(*lay.head_counts(heads[i])))
                 for i in range(k)]
        segs = np.cumsum([0] + sizes)
        total = int(segs[-1])
        tail_stats.setdefault(kind, deque(maxlen=4)).append(total / max(k, 1))
        tail_np = buf[base : base + total]
        if tail_np.size < total:
            fused = dev[4]
            sl = fused[: min(base + _bucket(total), fused.shape[0])]
            with _stage("fetch (late top-up)"):
                late = jax.device_get(sl)
            _acct("d2h MB", late.nbytes)
            tail_np = late[base : base + total]
        return (indices, currs, kind, dev, heads, segs, tail_np)

    def finish_compact(ctx):
        """Tail stage B (host-only now): chain per-frame rebuilds (serial
        worker) and submit per-frame finalize jobs (parallel pool)."""
        indices, currs, kind, dev, heads, segs, tail_np = ctx
        lay = layouts[kind]
        if kind in ("intra_all", "two_pass", "mixed"):
            d_recons, d_arts, d_qdcts, pos = dev[0], dev[1], dev[2], 0
            intra_head = None
        else:
            d_recons, d_arts, d_qdcts = dev[1][0], dev[1][1], dev[1][2]
            intra_head = dev[0] if kind == "intra_led" else None
            pos = 1 if kind == "intra_led" else 0
        futures = []
        for k in range(heads.shape[0]):
            t = None
            if tail_mode:
                t = (tail_np[segs[k] : segs[k + 1]] if tail_np is not None
                     else np.zeros(0, np.uint8))
            f = lay.split(heads[k], t)
            if intra_head is not None and k == 0:
                submit_compact(futures, indices[0], currs[0], f,
                               intra_head[2], intra_head[1], intra_head[0])
            else:
                submit_compact(futures, indices[k], currs[k], f,
                               d_qdcts, d_arts, d_recons, k - pos)
        return futures

    def fetch_chunks(n):
        """Compact path: ONE blocking device_get for the oldest ``n``
        pending chunks' prefetched buffers (a round trip is paid per call,
        not per buffer — see FETCHB), then parse and submit each chunk's
        host work."""
        batch = [pending_dev.popleft() for _ in range(n)]
        arrs = [pre if tail_mode else dev[4]
                for (_, _, _, dev, _, pre) in batch]
        t_f0 = time.time()
        with _stage("fetch (device_get)"):
            bufs = jax.device_get(arrs)
        if _TRACE:
            for b in batch:  # pop EVERY chunk's stamp (no leak across runs)
                ts = _trace_ts.pop(b[0][0], t_f0)
                print(f"TRACE fetch idx={b[0][0]} "
                      f"wait={1000*(time.time()-t_f0):.1f}ms "
                      f"since_dispatch={1000*(t_f0-ts):.1f}ms", flush=True)
        for (indices, currs, kind, dev, dispatch_dt, _), buf in zip(batch,
                                                                    bufs):
            _acct("d2h MB", buf.nbytes)
            ctx = parse_compact(indices, currs, kind, dev, buf)
            pending_fin.append((finish_compact(ctx),
                                dispatch_dt / max(len(indices), 1)))

    def fetch_chunk():
        if compact:
            return fetch_chunks(1)
        indices, currs, kind, dev, dispatch_dt, pre = pending_dev.popleft()
        per_frame_dt = dispatch_dt / max(len(indices), 1)
        nonlocal last_recon
        futures = []
        if kind in ("two_pass", "mixed"):
            # one bundled buffer per chunk (bitcast-concat of the full
            # planes, two_pass.py / chunk.py) -> split into per-frame views
            nb = nb_pad  # smalls are laid out over PADDED block counts
            hw = ph * pw
            with _stage("fetch (device_get)"):
                bundle = jax.device_get(dev[4])  # [K, NB] uint8
            _acct("d2h MB", bundle.nbytes)
            recons = []
            for k in range(bundle.shape[0]):
                buf = bundle[k]
                recon = buf[:hw].reshape(ph, pw)
                art = buf[hw : 2 * hw].reshape(ph, pw)
                qdct = buf[2 * hw : 4 * hw].view(np.int16).reshape(ph, pw)
                sm = buf[4 * hw :].view(np.int32)
                mode = int(sm[0])
                tail = sm[1 + 5 * nb :]
                if mode == INTRA:
                    per = np.concatenate([sm[1 : 1 + 2 * nb], tail])
                    # intra (GOP start or scene change) clears the host
                    # mirror of the reference deque
                    recon_hist.clear()
                    prev = None
                else:
                    per = np.concatenate([sm[1 : 1 + 5 * nb], tail])
                    # res_wo_mc subtracts the OLDEST reference (PFrame.py:116)
                    prev = recon_hist[0]
                futures.append(fin_pool.submit(
                    _finalize_arrays, indices[k], mode, currs[k],
                    recon, art, qdct, per, ec, prev))
                recon_hist.append(recon.copy())  # don't pin the chunk stack
                recons.append(recon)
            pending_fin.append((futures, per_frame_dt))
            return
        if kind == "intra_all":
            recons, arts, qdcts, smalls = jax.device_get(dev)
            for k in range(recons.shape[0]):
                futures.append(fin_pool.submit(
                    _finalize_arrays, indices[k], INTRA, currs[k],
                    recons[k], arts[k], qdcts[k], smalls[k], ec))
            last_recon = recons[-1].copy()
            pending_fin.append((futures, per_frame_dt))
            return
        intra_out, p_out = dev[0], dev[1]
        if kind == "intra_led":
            recon, art, qdct, smalls = jax.device_get(intra_out[:4])
            futures.append(fin_pool.submit(
                _finalize_arrays, indices[0], INTRA, currs[0],
                recon, art, qdct, smalls, ec))
            last_recon = recon
            if multiref:
                recon_hist.clear()
                recon_hist.append(recon)
        pos = 1 if kind == "intra_led" else 0
        recons, arts, qdcts, smalls = jax.device_get(p_out[:4])
        for k in range(recons.shape[0]):
            # res_wo_mc subtracts the OLDEST reference (PFrame.py:103,116)
            prev = (recon_hist[0] if multiref
                    else (last_recon if k == 0 else recons[k - 1]))
            futures.append(fin_pool.submit(
                _finalize_arrays, indices[pos + k], INTER, currs[pos + k],
                recons[k], arts[k], qdcts[k], smalls[k], ec, prev))
            if multiref:
                recon_hist.append(recons[k])
        if recons.shape[0]:
            last_recon = recons[-1].copy()
        pending_fin.append((futures, per_frame_dt))

    def write_chunk():
        futures, per_frame_dt = pending_fin.popleft()
        for fut in futures:
            # hand the FUTURE to the writer thread (write_async resolves it
            # there) — the fetch loop no longer waits on the finalize pool
            write_out(fut, per_frame_dt)

    truncated_tail = 0
    # fixed-QP row vector: identical every chunk, so build (and upload) it
    # once — per-chunk jnp.full dispatches cost ~2-3 ms/chunk on this host
    row_qps = jnp.full(ph // bs, ec.quantization_factor, jnp.int32)

    def _next_k(nr: int) -> int:
        """Frame count of the chunk that starts at absolute frame nr."""
        if nr >= params.frames_to_process:
            return 0
        return (min(MAX_CHUNK, params.frames_to_process - nr)
                if intra_only_cfg or mixed_path
                else min(MAX_CHUNK, ec.I_Period - nr % ec.I_Period,
                         params.frames_to_process - nr))

    def _prep(k: int):
        """Read + pad + input-pack one chunk — runs on the (ordered) prep
        worker so its ~1 ms/frame of host work overlaps the main thread's
        fetch waits.  Reads are sequential on f_in; the single worker keeps
        them ordered."""
        raw = f_in.read(y_size * k)
        n = len(raw) // y_size
        trunc = len(raw) % y_size
        if n == 0:
            return None, None, 0, trunc
        with _stage("prep: pad+stack"):
            frames_np = np.stack([
                pad_frame(np.frombuffer(
                    raw[i * y_size : (i + 1) * y_size], dtype=np.uint8
                ).reshape(params.height, params.width), bs)
                for i in range(n)
            ])
        ubuf = None
        if upack:
            from ..entropy.native import pack_input_frames

            with _stage("prep: input pack"):
                ubuf = pack_input_frames(frames_np, PK.input_esc_cap(ph, pw))
        return frames_np, ubuf, n, trunc

    if _TRACE:
        _trace_ts.clear()  # stale stamps from a previous run in this process
    prep_pool = ThreadPoolExecutor(max_workers=1)
    # the NEXT chunk's prep is submitted before the current one is
    # processed; its start frame assumes full-length reads, which only
    # diverges at EOF — where the over-read prep returns 0 frames (or the
    # current chunk's truncated tail breaks the loop) and is discarded
    assumed_read = _next_k(0)
    pending_prep = (prep_pool.submit(_prep, assumed_read)
                    if assumed_read else None)
    try:
        while True:
            if pending_prep is None:
                break
            intra_only = intra_only_cfg
            first_is_intra = n_read % ec.I_Period == 0
            frames_np, ubuf, n_frames, truncated_tail = pending_prep.result()
            k_next = _next_k(assumed_read)
            if k_next and n_frames and not truncated_tail:
                assumed_read += k_next
                pending_prep = prep_pool.submit(_prep, k_next)
            else:
                pending_prep = None
            # A truncated tail frame raises like the golden path
            # (np.frombuffer(buf).reshape on a short read) — but only after
            # the full frames read with it are encoded and written, matching
            # the reference's frame-at-a-time loop.
            if n_frames == 0:
                break
            t_disp = time.time()
            pshape = None
            fr_dev = None
            if ubuf is not None:
                with _stage("dispatch: h2d asarray"):
                    fr_dev = jnp.asarray(ubuf)
                pshape = (n_frames, ph, pw)
            if fr_dev is None:
                with _stage("dispatch: h2d asarray"):
                    fr_dev = jnp.asarray(frames_np)
            _acct("h2d MB", fr_dev.nbytes)
            if two_pass:
                dev, ref, hp, nv, prev_avg = encode_chunk_two_pass(
                    fr_dev, ref, hp, nv, prev_avg, budget0,
                    tbl[0], tbl[1], exp_p_frame, initial_qp,
                    bs, max(ec.search_range, 0), ec.fastME, frac,
                    first_is_intra, exact=exact, compact=compact, int8q=int8q,
                    mv8=mv8, q4=q4, tail=tail_mode, packed_shape=pshape, qfrac=qfrac,
                    devb=devb,
                )
                kind = "two_pass"
                # one bundled buffer per chunk (tail mode: the prefetched
                # fused prefix is the only copy in flight)
                leaves = () if tail_mode else (dev[4],)
            elif intra_only:
                # every frame clears the references: fully parallel vmap chunk
                dev = encode_chunk_intra_only(
                    fr_dev, row_qps, budget0, tbl[0], tbl[1],
                    initial_qp, bs, rc1, exact=exact, compact=compact,
                    int8q=int8q, q4=q4, tail=tail_mode, packed_shape=pshape, qfrac=qfrac,
                    devb=devb,
                )
                kind = "intra_all"
                leaves = (() if tail_mode else (dev[4],)) if compact else dev
            elif mixed_path:
                is_i = jnp.asarray(np.fromiter(
                    ((n_read + i) % ec.I_Period == 0 for i in range(n_frames)),
                    dtype=bool, count=n_frames))
                dev, ref, hp = encode_chunk_mixed(
                    fr_dev, ref, hp, is_i, row_qps, budget0, tbl[0], tbl[1],
                    initial_qp, bs, max(ec.search_range, 0), rc1, ec.fastME,
                    frac, exact=exact, compact=compact, int8q=int8q, mv8=mv8,
                    q4=q4, tail=tail_mode, packed_shape=pshape, qfrac=qfrac,
                    devb=devb,
                )
                kind = "mixed"
                leaves = () if tail_mode else (dev[4],)
            elif multiref:
                out = encode_chunk_multiref(
                    fr_dev, ref, hp, nv, row_qps, budget0,
                    tbl[0], tbl[1], initial_qp, bs, max(ec.search_range, 0),
                    rc1, ec.fastME, frac, first_is_intra, exact=exact,
                    compact=compact, int8q=int8q, mv8=mv8, q4=q4,
                    tail=tail_mode, packed_shape=pshape, qfrac=qfrac,
                    devb=devb,
                )
                ref, hp, nv = out[2], out[3], out[4]
                # normalize to the fetcher's (intra_out, p_out, _, _, packed)
                dev = ((out[0], out[1], None, None, out[5]) if compact
                       else (out[0], out[1]))
                kind = "intra_led" if first_is_intra else "p_only"
                leaves = ((() if tail_mode else (dev[4],))
                          if compact else dev[:2])
            else:
                dev = encode_chunk(
                    fr_dev, ref, hp, row_qps, budget0, tbl[0], tbl[1],
                    initial_qp, bs, max(ec.search_range, 0), rc1, ec.fastME, frac,
                    first_is_intra, exact=exact, compact=compact, int8q=int8q,
                    mv8=mv8, q4=q4, tail=tail_mode, packed_shape=pshape, qfrac=qfrac,
                    devb=devb,
                )
                ref, hp = dev[2], dev[3]
                kind = "intra_led" if first_is_intra else "p_only"
                leaves = ((() if tail_mode else (dev[4],))
                          if compact else dev[:2])
            with _stage("dispatch: async-copy+prefetch"):
                for leaf in jax.tree_util.tree_leaves(leaves):
                    leaf.copy_to_host_async()
                pre = tail_prefetch(kind, dev, n_frames) if compact else None
            if _TRACE:
                _trace_ts[n_read + 1] = time.time()
            indices = list(range(n_read + 1, n_read + n_frames + 1))  # 1-based
            pending_dev.append((indices, frames_np, kind, dev,
                                time.time() - t_disp, pre))
            if STAGE_TIMER is not None:
                STAGE_TIMER.totals["dispatch (pad+h2d+enqueue)"] += time.time() - t_disp
                STAGE_TIMER.counts["dispatch (pad+h2d+enqueue)"] += n_frames
            n_read += n_frames
            if truncated_tail:
                break
            if compact:
                # wait for FETCHB chunks past the pipeline depth, then take
                # them in one batched device_get (latency amortization)
                while len(pending_dev) >= DEPTH + FETCHB:
                    fetch_chunks(FETCHB)
            else:
                while len(pending_dev) > DEPTH:
                    fetch_chunk()
            while len(pending_fin) > 1:
                write_chunk()
        while pending_dev:
            if compact:
                fetch_chunks(min(FETCHB, len(pending_dev)))
            else:
                fetch_chunk()
        while pending_fin:
            write_chunk()
        if truncated_tail:
            raise ValueError(
                f"truncated frame: read {truncated_tail} of {y_size} bytes"
            )
    finally:
        prep_pool.shutdown(wait=True)
        if rebuilder is not None:
            rebuilder.shutdown()
        fin_pool.shutdown(wait=True)
        LAST_RUN_STATS.clear()
        LAST_RUN_STATS.update(overflow_frames=overflow_frames[0],
                              frames=n_read)
        if compact and n_read and overflow_frames[0] > max(n_read // 50, 2):
            # results stay correct; this flags a mis-sized transport cap
            # (ops/pack.qcap_fraction and friends are sized so this never
            # fires on measured content classes — a hot report means a new
            # class worth a cap bump)
            logger.warning(
                f"compact-transfer overflow on {overflow_frames[0]}/{n_read} "
                f"frames: each costs a synchronous full-plane fetch")
        if STAGE_TIMER is not None:
            logger.info("stage breakdown (BVC_PROFILE):\n" + STAGE_TIMER.report())


def shard_device_count(ec) -> int:
    """Devices the GOP-sharded lanes spread over: one GOP per device, as
    many as ``parallel_gops`` asks for — never silently fewer."""
    n = len(jax.devices())
    if ec.parallel_gops > n:
        raise ValueError(f"parallel_gops={ec.parallel_gops} needs that many "
                         f"devices; JAX sees {n}")
    return ec.parallel_gops


def _run_gop_sharded(params, ec, f_in, tbl, write_out):
    """Multi-chip encode: whole GOPs sharded ONE PER DEVICE over the mesh's
    ``data`` axis (parallel/gop.py), producing the real bitstream.

    Every GOP starts with an I-frame that clears the references
    (reference encoder.py:174-186), so GOPs are independent, and each shard
    runs the *identical* serial chunk program under ``shard_map`` — the
    artifact tree is byte-identical to a single-device run
    (tests/test_parallel.py).  Eligibility (checked by the caller):
    nRefFrames == 1 and RCflag <= 1 (RC 2/3 carry the previous frame's
    average QP across GOP boundaries, a serial dependence).
    """
    from concurrent.futures import ThreadPoolExecutor

    from ..ops import pack as PK
    from ..parallel.gop import gop_batch_fn, shard_gops
    from ..parallel.mesh import make_mesh

    bs = ec.block_size
    y_size = params.width * params.height
    intra_only = ec.I_Period == 1
    # with I_Period == 1 the serial path encodes MAX_CHUNK-frame all-intra
    # batches; shard the same program with per-device frame groups
    K = MAX_CHUNK if intra_only else ec.I_Period
    rc1 = ec.RCflag == 1
    budget0 = jnp.float32(bit_budget_per_frame(ec)) if ec.RCflag else jnp.float32(0)
    initial_qp = jnp.int32(ec.quantization_factor)
    frac = ec.fracMeEnabled
    exact = getattr(ec, "exact_transform", False)
    compact = (os.environ.get("BVC_COMPACT", "1") != "0"
               and params.height * params.width * 255 < 2 ** 31)
    int8q = PK.qdct_int8_safe(ec)
    mv8 = PK.mv_int8_safe(ec)
    q4 = PK.qdct_nibble_safe(ec)
    pw, ph = padded_dims(params.width, params.height, bs)
    nb_pad = (ph // bs) * (pw // bs)
    qfrac = PK.qcap_fraction(ec)
    qcap = PK.qdct_caps(nb_pad, bs, qfrac)
    ecap = PK.esc_cap(ph, pw)
    qecap = PK.qe_cap(qcap)
    q4cap = PK.q4e_cap(qcap)
    jt = q4 and not rc1 and ec.RCflag == 0
    jkcap = PK.jk_cap(ph, pw, jt)
    vbytes = 1 if int8q else 2
    layout = (PK.FrameLayout(ph, pw, bs, vbytes, False, False, q4=q4,
                             qfrac=qfrac)
              if intra_only
              else PK.FrameLayout(ph, pw, bs, vbytes, True, True, mv8, q4,
                                  jt, mvk=3 if ec.nRefFrames > 1 else 2,
                                  mvn=PK.mv_nibble_safe(ec), qfrac=qfrac))

    data = shard_device_count(ec)
    mesh = make_mesh(data, data=data, space=1)
    nbr = ph // bs
    row_qps = jnp.full(nbr, ec.quantization_factor, jnp.int32)
    def batch_fn_for(pshape):
        return gop_batch_fn(mesh, intra_only, bs, max(ec.search_range, 0),
                            rc1, ec.fastME, frac, exact, compact, int8q,
                            n_ref=ec.nRefFrames, mv8=mv8, q4=q4,
                            packed_shape=pshape, qfrac=qfrac)

    # compact uploads for the sharded path too (same fallback rules as the
    # serial pipeline: native packer unavailable / escape-heavy -> raw)
    upack = os.environ.get("BVC_UPACK", "1") != "0"
    ucap = PK.input_esc_cap(ph, pw)

    fin_pool = ThreadPoolExecutor(max_workers=4)
    pending: deque = deque()  # (n_real_per_gop, frames, base_index, dev, dt)
    frame_index = 0
    truncated_tail = 0

    def planes_of(dev, g, k):
        """(qdct, art, recon) device planes of frame k in shard g (fallback)."""
        if intra_only:
            return dev[2][g, k], dev[1][g, k], dev[0][g, k]
        if k == 0:
            return dev[0][2][g], dev[0][1][g], dev[0][0][g]
        return dev[1][2][g, k - 1], dev[1][1][g, k - 1], dev[1][0][g, k - 1]

    def fetch_batch():
        n_real, gop_frames, base_index, dev, dispatch_dt = pending.popleft()
        per_frame_dt = dispatch_dt / max(sum(n_real), 1)
        futures = []
        idx = base_index
        if compact:
            packed = jax.device_get(dev[4])
            for g, n in enumerate(n_real):
                # per-GOP reference history (every GOP starts intra, which
                # clears it; the gray seed only keeps the stack non-empty)
                hist: deque = deque(
                    [np.full((ph, pw), 128, np.uint8)], maxlen=ec.nRefFrames)
                for k in range(n):
                    f = layout.split(packed[g, k])
                    qd, ad, rd = planes_of(dev, g, k)
                    jover = f["jn"] > jkcap
                    q_full = (jax.device_get(qd)
                              if f["qt"] > qcap or f["qn"] > qecap
                              or f["qn4"] > q4cap else None)
                    a_full = (jax.device_get(ad)
                              if int(f["meta"][0]) == INTER
                              and (f["an"] > ecap or jover) else None)
                    r_full = (jax.device_get(rd)
                              if f["rn"] > ecap or jover else None)
                    rebuilt = _rebuild_frame(f, ec, hist, q_full, r_full,
                                             a_full)
                    futures.append(fin_pool.submit(
                        _finalize_compact, idx, gop_frames[g][k], f, ec,
                        rebuilt, a_full))
                    idx += 1
        elif intra_only:
            recons, arts, qdcts, smalls = jax.device_get(dev[:4])
            for g, n in enumerate(n_real):
                for k in range(n):
                    futures.append(fin_pool.submit(
                        _finalize_arrays, idx, INTRA, gop_frames[g][k],
                        recons[g, k], arts[g, k], qdcts[g, k], smalls[g, k], ec))
                    idx += 1
        else:
            intra_out, p_out = jax.device_get((dev[0], dev[1]))
            recon_i, art_i, qdct_i, smalls_i = intra_out
            recons, arts, qdcts, smalls = p_out
            for g, n in enumerate(n_real):
                hist: deque = deque(maxlen=ec.nRefFrames)  # per-GOP history
                for k in range(n):
                    if k == 0:
                        futures.append(fin_pool.submit(
                            _finalize_arrays, idx, INTRA, gop_frames[g][0],
                            recon_i[g], art_i[g], qdct_i[g], smalls_i[g], ec))
                        hist.append(recon_i[g])
                    else:
                        # res_wo_mc subtracts the OLDEST reference
                        futures.append(fin_pool.submit(
                            _finalize_arrays, idx, INTER, gop_frames[g][k],
                            recons[g, k - 1], arts[g, k - 1], qdcts[g, k - 1],
                            smalls[g, k - 1], ec, hist[0]))
                        hist.append(recons[g, k - 1])
                    idx += 1
        for fut in futures:
            # the writer thread resolves the future (encode_video.write_async)
            write_out(fut, per_frame_dt)

    try:
        while True:
            if frame_index >= params.frames_to_process:
                break
            want = min(data * K, params.frames_to_process - frame_index)
            raw = f_in.read(y_size * want)
            n_frames = len(raw) // y_size
            truncated_tail = len(raw) % y_size
            if n_frames == 0:
                break
            t_disp = time.time()
            frames = [
                pad_frame(np.frombuffer(
                    raw[i * y_size : (i + 1) * y_size], dtype=np.uint8
                ).reshape(params.height, params.width), bs)
                for i in range(n_frames)
            ]
            gop_frames = [frames[i : i + K] for i in range(0, n_frames, K)]
            n_real = [len(gf) for gf in gop_frames]
            # pad the final short GOP (the scan is forward: padding frames
            # cannot affect real ones) and the batch up to the data-axis
            # size with dummy GOPs; their outputs are dropped
            padded = [gf + [gf[-1]] * (K - len(gf)) for gf in gop_frames]
            while len(padded) < data:
                padded.append([padded[0][0]] * K)
                n_real.append(0)
            gops_np = np.stack([np.stack(gf) for gf in padded])
            upload, pshape = gops_np, None
            if upack:
                from ..entropy.native import pack_input_frames

                bufs = [pack_input_frames(g, ucap) for g in gops_np]
                if all(b is not None for b in bufs):
                    upload = np.stack(bufs)
                    pshape = (K, ph, pw)
            batch_fn = batch_fn_for(pshape)
            dev = batch_fn(shard_gops(mesh, upload), row_qps, budget0,
                           tbl[0], tbl[1], initial_qp)
            leaves = ((dev[4],) if compact
                      else (dev[:4] if intra_only else (dev[0], dev[1])))
            for leaf in jax.tree_util.tree_leaves(leaves):
                leaf.copy_to_host_async()
            pending.append((n_real, gop_frames, frame_index + 1, dev,
                            time.time() - t_disp))
            frame_index += n_frames
            while len(pending) > 1:
                fetch_batch()
            if truncated_tail:
                break
        while pending:
            fetch_batch()
        if truncated_tail:
            raise ValueError(
                f"truncated frame: read {truncated_tail} of {y_size} bytes"
            )
    finally:
        fin_pool.shutdown(wait=True)
        LAST_RUN_STATS.clear()
        LAST_RUN_STATS.update(devices=data)


def _parse_prediction(data, ec, params, is_intra):
    """Entropy-decode one frame's prediction payload into planes."""
    bs = ec.block_size
    pw, ph = padded_dims(params.width, params.height, bs)
    nbc = pw // bs
    nbr = ph // bs
    per_row = 1 + nbc * (1 if is_intra else (3 if ec.nRefFrames > 1 else 2))
    syms = decode_symbols_np(data, nbr * per_row).reshape(nbr, per_row)
    row_qps = ec.quantization_factor + syms[:, 0]
    if is_intra:
        return row_qps.astype(np.int32), syms[:, 1:].astype(np.int32), None
    k = 3 if ec.nRefFrames > 1 else 2
    diffs = syms[:, 1:].reshape(-1, k)
    if k == 2:
        diffs = np.hstack([diffs, np.zeros((diffs.shape[0], 1), np.int64)])
    mvs = np.cumsum(diffs, axis=0).reshape(nbr, nbc, 3).astype(np.int32)
    return row_qps.astype(np.int32), None, mvs


def _parse_dct(data, ec, params):
    bs = ec.block_size
    pw, ph = padded_dims(params.width, params.height, bs)
    nbc = pw // bs
    nbr = ph // bs
    scans = decode_dct_scans(data, nbr * nbc, bs * bs, EOB_MARKER)
    # int16 halves the host->device upload; any quantized coefficient fits
    # (|q| <= 255 * bs <= 4080, ops/pack.py range analysis)
    out = np.zeros((nbr * nbc, bs * bs), dtype=np.int16)
    out[:, zigzag_indices(bs)] = scans  # flat[zz[k]] = scan[k]
    return (
        out.reshape(nbr, nbc, bs, bs).swapaxes(1, 2).reshape(nbr * bs, nbc * bs)
    )


def _parse_frames(encoded_fh, ec, params):
    """Yield (index, mode, row_qps, modes|None, mvs|None, qdct) per frame.

    Stops at end-of-stream (reference decoder.py:46-48's loop break) and —
    a robustness superset of the reference, which crashes there — at a
    stream truncated mid-frame: the last complete frame is the final one
    decoded, earlier frames are unaffected."""
    frame_index = 0
    while True:
        frame_index += 1
        mode_byte = encoded_fh.read(1)
        if frame_index > params.frames_to_process or not mode_byte:
            return
        mode = int.from_bytes(mode_byte)
        len2 = encoded_fh.read(2)
        pred_data = encoded_fh.read(int.from_bytes(len2)) if len(len2) == 2 else b""
        if len(len2) < 2 or len(pred_data) < int.from_bytes(len2):
            logger.warning(f"encoded stream truncated mid-frame {frame_index}; stopping")
            return
        row_qps, modes, mvs = _parse_prediction(pred_data, ec, params, mode == INTRA)
        len3 = encoded_fh.read(3)
        dct_data = encoded_fh.read(int.from_bytes(len3)) if len(len3) == 3 else b""
        if len(len3) < 3 or len(dct_data) < int.from_bytes(len3):
            logger.warning(f"encoded stream truncated mid-frame {frame_index}; stopping")
            return
        qdct = _parse_dct(dct_data, ec, params)
        yield frame_index, mode, row_qps, modes, mvs, qdct


def decode_video(params: InputParameters):
    """Pipelined decode: host entropy parsing (native codec) feeds async
    device dispatches.  The decode mirrors the encoder's GOP chunking — one
    program per [I P..P] / all-intra segment, with a rolling reference stack
    for nRefFrames > 1.

    By default (BVC_DCOMPACT=1) decoded frames travel as 2-bit correction
    codes against the integer-exact reconstruction guess the host rebuilds
    from the parsed stream (qdct + MC/intra prediction — the same
    ops/pack.py machinery the encoder uses), ~HW/4 bytes instead of the HW
    plane.
    Escape-overflow frames fall back to fetching the full decoded plane."""
    ec = params.encoder_config
    file_io = FileIOHelper(params)
    bs = ec.block_size
    width, height = padded_dims(params.width, params.height, bs)
    frac = ec.fracMeEnabled
    compact = os.environ.get("BVC_DCOMPACT", "1") != "0"
    cape = None
    from ..ops import pack as PK

    if compact:
        cape = PK.esc_cap(height, width)
    hw = height * width

    with open(file_io.get_mc_reconstructed_file_name(), "rb") as recon_fh, \
         open(file_io.get_encoded_file_name(), "rb") as encoded_fh, \
         overwrite_open(file_io.get_mc_decoded_file_name()) as decoded_fh:

        pending: deque = deque()
        # host mirror of the decoder's reference deque (gray-seeded,
        # reference decoder.py:34-38) for the compact-path rebuild
        hist: deque = deque([np.full((height, width), 128, np.uint8)],
                            maxlen=ec.nRefFrames)

        def rebuild(meta, row, dev_decoded, k):
            """One frame's decoded plane from its correction-code row +
            the parsed stream fields (host twin of _decode_codes_row)."""
            _, mode, row_qps, modes, mvs, qdct = meta
            codes2 = row[: hw // 4]
            esc = row[hw // 4 : hw // 4 + cape]
            rn = int(row[hw // 4 + cape :].view(np.int32)[0])
            if rn > cape:  # escape overflow: fetch the full plane (rare)
                dec = np.asarray(dev_decoded[k])
                if mode == INTRA:
                    hist.clear()
                hist.append(dec)
                return dec
            x, _ = PK.host_x_art(np.asarray(qdct, np.int16), row_qps, bs,
                                 want_art=False)
            if mode == INTRA:
                hist.clear()
                dec = PK.host_rebuild_intra_recon(
                    qdct, modes.astype(np.int32), row_qps, codes2, esc, bs,
                    x=x)
            else:
                refs = np.stack(hist)
                hps = (np.stack([_host_halfpel(r) for r in hist])
                       if frac else None)
                pred = PK.host_pred_inter(refs, mvs, bs, frac, hps)
                dec = PK.unpack_vs_base(
                    codes2, esc, PK.host_recon_guess_from_x(x, pred, bs))
            hist.append(dec)
            return dec

        from concurrent.futures import ThreadPoolExecutor

        # one ordered worker: the rebuild chain is reference-serial (frame
        # k's plane predicts k+1), but it overlaps the main thread's
        # psnr/write work (the native kernels release the GIL)
        rebuild_pool = ThreadPoolExecutor(max_workers=1)

        def drain_one():
            indices, dev, packed, metas = pending.popleft()
            if compact:
                rows = jax.device_get(packed)
                planes = [rebuild_pool.submit(rebuild, metas[k], rows[k],
                                              dev, k)
                          for k in range(len(indices))]
            else:
                arr = np.asarray(dev)
                planes = arr[None] if arr.ndim == 2 else arr
            for idx, decoded_np in zip(indices, planes):
                if hasattr(decoded_np, "result"):
                    decoded_np = decoded_np.result()
                ref_plane = np.frombuffer(recon_fh.read(width * height), dtype=np.uint8)
                frame_psnr = psnr(decoded_np, ref_plane.reshape(height, width))
                logger.info(f"{idx:2}: psnr [{round(frame_psnr, 2):6.2f}]")
                write_y_only_frame(decoded_fh, decoded_np)

        try:
            _decode_chunked(params, ec, encoded_fh, pending, drain_one, compact)
            while pending:
                drain_one()
        finally:
            rebuild_pool.shutdown(wait=True)
    logger.info("End decoding")


def _decode_chunked(params, ec, encoded_fh, pending, drain_one, compact=False):
    from .chunk import decode_chunk, decode_chunk_intra_only, decode_chunk_multiref

    bs = ec.block_size
    width, height = padded_dims(params.width, params.height, bs)
    frac = ec.fracMeEnabled
    nbr, nbc = height // bs, width // bs
    exact = getattr(ec, "exact_transform", False)
    multiref = ec.nRefFrames > 1
    R = ec.nRefFrames
    gray = jnp.full((height, width), 128, dtype=jnp.uint8)
    if multiref:
        # rolling reference stack (slot 0 = oldest), seeded with one gray
        # frame like the reference's deque (decoder.py:34-38)
        ref = jnp.zeros((R, height, width), jnp.uint8).at[0].set(gray)
        hp = jnp.zeros((R, 2 * height, 2 * width), jnp.uint8)
        if frac:
            hp = hp.at[0].set(build_half_pel(gray))
        nv = jnp.int32(1)
    else:
        ref = gray
        hp = build_half_pel(gray) if frac else jnp.zeros((2 * height, 2 * width), jnp.uint8)
    buf = []  # parsed frames of the chunk being assembled

    def flush():
        nonlocal ref, hp, nv, buf
        if not buf:
            return
        indices = [b[0] for b in buf]
        qdcts = jnp.asarray(np.stack([b[5] for b in buf]))
        qps = jnp.asarray(np.stack([b[2] for b in buf]))
        all_intra = all(b[1] == INTRA for b in buf)
        packed = None
        if all_intra and len(buf) > 1 and not multiref:
            modes = jnp.asarray(np.stack([b[3] for b in buf]))
            out = decode_chunk_intra_only(qdcts, modes, qps, bs, frac,
                                          exact=exact, compact=compact)
            decoded, ref, hp = out[:3]
            if compact:
                packed = out[3]
        else:
            first_is_intra = buf[0][1] == INTRA
            mvs = np.stack([
                b[4] if b[4] is not None else np.zeros((nbr, nbc, 3), np.int32)
                for b in buf
            ])
            modes0 = jnp.asarray(
                buf[0][3] if first_is_intra else np.zeros((nbr, nbc), np.int32))
            if multiref:
                out = decode_chunk_multiref(
                    qdcts, jnp.asarray(mvs), qps, modes0, ref, hp, nv,
                    bs, frac, first_is_intra, exact=exact, compact=compact,
                )
                decoded, ref, hp, nv = out[:4]
                if compact:
                    packed = out[4]
            else:
                out = decode_chunk(
                    qdcts, jnp.asarray(mvs), qps, modes0, ref, hp,
                    bs, frac, first_is_intra, exact=exact, compact=compact,
                )
                decoded, ref, hp = out[:3]
                if compact:
                    packed = out[3]
        (packed if compact else decoded).copy_to_host_async()
        pending.append((indices, decoded, packed, list(buf)))
        buf = []

    for rec in _parse_frames(encoded_fh, ec, params):
        is_intra = rec[1] == INTRA
        if buf:
            buf_all_intra = all(b[1] == INTRA for b in buf)
            # chunk shapes: [I P..P], [P..P], or (single-ref) all-intra
            # [I I ..]; the multiref program handles one leading intra only
            if is_intra and (multiref or not buf_all_intra):
                flush()
            elif not is_intra and buf_all_intra and len(buf) > 1:
                flush()
        buf.append(rec)
        if len(buf) >= MAX_CHUNK:
            flush()
        while len(pending) > 2:
            drain_one()
    flush()
