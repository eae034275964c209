"""Command-line interface.

The reference has no CLI — its ``main.py`` hardcodes one deliverable run
(main.py:8-10) and every experiment is a Python file to edit.  This module
exposes the same flows as subcommands::

    python -m basic_video_codec_tpu encode  seq.y -W 352 -H 288 -q 5 ...
    python -m basic_video_codec_tpu decode  seq.y -W 352 -H 288 -q 5 ...
    python -m basic_video_codec_tpu run     seq.y ...      # encode+plot+decode
    python -m basic_video_codec_tpu deliverable [--synthetic]
    python -m basic_video_codec_tpu rd-sweep seq.y ...
    python -m basic_video_codec_tpu ablation seq.y ...
    python -m basic_video_codec_tpu rc-compare seq.y ...
"""

import argparse
import sys

from .config import BACKENDS, EncoderConfig, InputParameters


def _add_codec_args(p):
    p.add_argument("y_only_file")
    p.add_argument("-W", "--width", type=int, default=352)
    p.add_argument("-H", "--height", type=int, default=288)
    p.add_argument("-n", "--frames", type=int, default=21)
    p.add_argument("-i", "--block-size", type=int, default=16)
    p.add_argument("-r", "--search-range", type=int, default=4)
    p.add_argument("-q", "--qp", type=int, default=5)
    p.add_argument("--i-period", type=int, default=8)
    p.add_argument("--nref", type=int, default=1)
    p.add_argument("--fastme", action="store_true")
    p.add_argument("--fracme", action="store_true")
    p.add_argument("--rc", type=int, default=0, choices=(0, 1, 2, 3))
    p.add_argument("--target-br", type=int, default=0)
    p.add_argument("--backend", default="auto", choices=BACKENDS)
    p.add_argument("--parallel-gops", type=int, default=0,
                   help="encode this many GOPs concurrently, one per device "
                        "(multi-chip; output is byte-identical to serial)")


def _params(args) -> InputParameters:
    ec = EncoderConfig(
        block_size=args.block_size, search_range=args.search_range,
        I_Period=args.i_period, quantization_factor=args.qp, nRefFrames=args.nref,
        fastME=args.fastme, fracMeEnabled=args.fracme, RCflag=args.rc,
        targetBR=args.target_br, resolution=(args.width, args.height),
        backend=args.backend, parallel_gops=args.parallel_gops,
    )
    return InputParameters(args.y_only_file, args.width, args.height, ec, args.frames)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="basic_video_codec_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    for name in ("encode", "decode", "run", "validate"):
        _add_codec_args(sub.add_parser(name))

    p = sub.add_parser("deliverable", help="reference assign3 deliverable run")
    p.add_argument("y_only_file", nargs="?", default="data/e3_CIF.y")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic stand-in sequence if missing")
    p.add_argument("--backend", default="auto")

    p = sub.add_parser("rd-sweep")
    p.add_argument("y_only_file")
    p.add_argument("-W", "--width", type=int, default=352)
    p.add_argument("-H", "--height", type=int, default=288)
    p.add_argument("-n", "--frames", type=int, default=10)
    p.add_argument("--output-dir", default="results")
    p.add_argument("--backend", default="auto")

    p = sub.add_parser("ablation")
    p.add_argument("y_only_file")
    p.add_argument("-W", "--width", type=int, default=352)
    p.add_argument("-H", "--height", type=int, default=288)
    p.add_argument("-n", "--frames", type=int, default=10)
    p.add_argument("--backend", default="auto")

    p = sub.add_parser("rc-compare")
    p.add_argument("y_only_file")
    p.add_argument("-W", "--width", type=int, default=352)
    p.add_argument("-H", "--height", type=int, default=288)
    p.add_argument("-n", "--frames", type=int, default=21)
    p.add_argument("--backend", default="auto")

    args = parser.parse_args(argv)

    if args.cmd == "encode":
        from .encoder import encode_video

        encode_video(_params(args))
    elif args.cmd == "decode":
        from .decoder import decode_video

        decode_video(_params(args))
    elif args.cmd == "run":
        from .experiments.pipeline_run import encode_plot_decode

        encode_plot_decode(_params(args))
    elif args.cmd == "validate":
        # round-trip check: decoded output must equal the encoder's
        # reconstruction bit-for-bit (the codec invariant)
        import filecmp

        from .io.fileio import FileIOHelper

        io = FileIOHelper(_params(args), create_dirs=False)
        ok = filecmp.cmp(io.get_mc_reconstructed_file_name(),
                         io.get_mc_decoded_file_name(), shallow=False)
        print(f"decode == reconstruction: {'OK' if ok else 'MISMATCH'}")
        return 0 if ok else 1
    elif args.cmd == "deliverable":
        from .experiments import rc_study
        from .experiments.data import ensure_sequence

        path = args.y_only_file
        if args.synthetic:
            path = ensure_sequence(path, 352, 288, 21)
        rc_study.deliverable(path, backend=args.backend)
    elif args.cmd == "rd-sweep":
        from .experiments.rd_sweep import run_sweep

        run_sweep(args.y_only_file, args.width, args.height,
                  num_frames=args.frames, output_dir=args.output_dir,
                  backend=args.backend)
    elif args.cmd == "ablation":
        from .experiments.ablation import run_ablation

        run_ablation(args.y_only_file, args.width, args.height,
                     num_frames=args.frames, backend=args.backend)
    elif args.cmd == "rc-compare":
        from .experiments.rc_study import rc_mode_comparison

        rc_mode_comparison(args.y_only_file, args.width, args.height,
                           num_frames=args.frames, backend=args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
