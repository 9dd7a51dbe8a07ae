"""``sfq-torch`` command-line interface: the ``sfq`` encode/decode path on
PyTorch (CUDA by default, ``--device cpu`` for the kernels' plain
versions).

Usage:
  sfq-torch [-1|-2|-3|-4] in.fastq [-o out.sfq]     # encode
  sfq-torch -d in.sfq [-o out.fastq]                # decode
  sfq-torch -d in.sfq                               # decode to stdout
  cat in.fastq | sfq-torch - -o out.sfq             # stdin encode
  sfq-torch --streaming in.fastq -o out.sfq         # bounded memory
  sfq-torch --streaming --resume in.fastq -o out.sfq  # after a crash
  sfq-torch -d --streaming in.sfq -o out.fastq      # bounded memory
  sfq-torch --sharded in.fastq -o out.sfq           # over all cards
  sfq-torch --sharded --device cpu in.fastq -o out.sfq  # a CPU mesh
  sfq-torch --backend oracle in.fastq -o out.sfq    # the NumPy oracle

Containers are byte-identical to the JAX package's ``sfq``, with or
without ``--sharded`` (which also combines with ``--streaming`` and
``-d``). ``--backend oracle`` codes every stream with the NumPy oracle
(the normative bit format) instead of the card, and touches no device:
slow, for small inputs and for bisecting a fault between the host and
the kernels (``sfq --backend oracle`` gives the same bytes).
"""

from __future__ import annotations

import argparse
import os
import sys

from . import __version__
from .api import (decode_fastq, decode_file_streaming, encode_fastq,
                  encode_file_streaming)
from .config import config_for_level
from .parallel import sharded
from .parallel.mesh import make_mesh


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sfq-torch",
        description="lossless FASTQ codec on PyTorch/CUDA "
                    "(containers identical to sfq)")
    p.add_argument("input", help="input file, or '-' for stdin")
    p.add_argument("-o", "--output",
                   help="output file (default: input+'.sfq' on encode, "
                        "stdout on decode)")
    p.add_argument("-d", "--decode", action="store_true",
                   help="decompress instead of compress")
    for lv in (1, 2, 3, 4):
        p.add_argument(f"-{lv}", dest="level", action="store_const",
                       const=lv, help=f"compression level {lv}"
                       + (" (default)" if lv == 3 else ""))
    p.add_argument("-f", "--force", action="store_true",
                   help="overwrite existing output file")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print per-stream statistics")
    p.add_argument("--block-records", type=int, default=None, metavar="N",
                   help="records per independently-decodable block "
                        "(encode only; default 65536)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the coder (default: cuda)")
    p.add_argument("--backend", choices=["torch", "oracle"],
                   default="torch",
                   help="coder: the kernels on --device (torch, the "
                        "default) or the NumPy oracle on the host, which "
                        "ignores --device")
    p.add_argument("--streaming", action="store_true",
                   help="bounded-memory streaming encode/decode for huge "
                        "files (encode is resumable: rerun with --resume "
                        "after a crash)")
    p.add_argument("--resume", action="store_true",
                   help="with --streaming: continue an interrupted output")
    p.add_argument("--chunk-bytes", type=int, default=1 << 28, metavar="N",
                   help="with --streaming encode: input bytes read at a "
                        "time (default 256 MiB)")
    p.add_argument("--sharded", action="store_true",
                   help="split each window's blocks over all the node's "
                        "cards (with --device cpu: a one-entry CPU mesh)")
    p.add_argument("--version", action="version",
                   version=f"sfq-torch {__version__}")
    p.set_defaults(level=3)
    return p


def _stats(encoded: bytes, raw_len: int, out=None) -> None:
    out = out if out is not None else sys.stderr
    from .utils.stats import container_report
    rep = container_report(encoded)
    print(f"records:         {rep['records']}  "
          f"(blocks: {rep['blocks']})", file=out)
    print(f"raw bytes:       {raw_len}", file=out)
    print(f"compressed:      {rep['compressed_bytes']}"
          f"  (ratio {raw_len / max(rep['compressed_bytes'], 1):.3f})",
          file=out)
    for name, b in sorted(rep["stream_bytes"].items(),
                          key=lambda kv: -kv[1]):
        print(f"  {name:<6} {b:>12}", file=out)
    print(f"  {'(hdrs)':<6} {rep['header_overhead_bytes']:>12}", file=out)


def _streaming(args, overrides: dict) -> int:
    """--streaming: file to file in bounded memory (encode resumable)."""
    if args.input == "-" or not args.output:
        print("sfq-torch: --streaming needs a file input and -o output",
              file=sys.stderr)
        return 2
    if not os.path.exists(args.input):
        print(f"sfq-torch: {args.input}: no such file", file=sys.stderr)
        return 2
    if os.path.exists(args.output) and not args.force and not (
            args.resume and not args.decode):
        print(f"sfq-torch: {args.output} exists (use -f to overwrite)",
              file=sys.stderr)
        return 2
    try:
        if args.decode and args.sharded:
            sharded.decode_file_streaming_sharded(args.input, args.output,
                                                  mesh=_mesh(args))
        elif args.decode:
            decode_file_streaming(args.input, args.output,
                                  device=args.device, backend=args.backend)
        elif args.sharded:
            sharded.encode_file_streaming_sharded(
                args.input, args.output, level=args.level, mesh=_mesh(args),
                chunk_bytes=args.chunk_bytes, resume=args.resume,
                **overrides)
        else:
            encode_file_streaming(args.input, args.output, level=args.level,
                                  device=args.device,
                                  chunk_bytes=args.chunk_bytes,
                                  resume=args.resume, backend=args.backend,
                                  **overrides)
    except (ValueError, RuntimeError, OSError) as e:
        print(f"sfq-torch: {e}", file=sys.stderr)
        return 1
    return 0


def _mesh(args):
    """--sharded's mesh: every card of the node, or with --device cpu a
    one-entry CPU mesh (raises without a card, as the one-card path
    does)."""
    return make_mesh(devices=["cpu"]) if args.device == "cpu" \
        else make_mesh()


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.resume and not args.streaming:
        print("sfq-torch: --resume needs --streaming", file=sys.stderr)
        return 2
    if args.chunk_bytes < 1:
        print("sfq-torch: --chunk-bytes must be positive", file=sys.stderr)
        return 2
    if args.sharded and args.backend != "torch":
        # the sharded path is the mesh of cards; running it under
        # --backend oracle would defeat backend bisection
        print("sfq-torch: --sharded requires the torch backend "
              f"(got --backend {args.backend})", file=sys.stderr)
        return 2
    overrides = {}
    if args.block_records:
        overrides["block_records"] = args.block_records
    if args.streaming:
        return _streaming(args, overrides)

    if args.input == "-":
        data = sys.stdin.buffer.read()
    else:
        if not os.path.exists(args.input):
            print(f"sfq-torch: {args.input}: no such file", file=sys.stderr)
            return 2
        with open(args.input, "rb") as f:
            data = f.read()

    try:
        if args.decode and args.sharded:
            result = sharded.decode_fastq_sharded(data, mesh=_mesh(args))
        elif args.decode:
            result = decode_fastq(data, device=args.device,
                                  backend=args.backend)
        elif args.sharded:
            result = sharded.encode_fastq_sharded(
                data, config_for_level(args.level, **overrides),
                mesh=_mesh(args))
        else:
            result = encode_fastq(data, level=args.level,
                                  device=args.device, backend=args.backend,
                                  **overrides)
    except (ValueError, RuntimeError) as e:
        print(f"sfq-torch: {e}", file=sys.stderr)
        return 1

    if args.output:
        dst = args.output
    elif args.decode:
        dst = "-"
    else:
        dst = (args.input + ".sfq") if args.input != "-" else "-"

    if dst == "-":
        sys.stdout.buffer.write(result)
    else:
        if os.path.exists(dst) and not args.force:
            print(f"sfq-torch: {dst} exists (use -f to overwrite)",
                  file=sys.stderr)
            return 2
        with open(dst, "wb") as f:
            f.write(result)

    if args.verbose and not args.decode:
        _stats(result, len(data))
    return 0


if __name__ == "__main__":
    sys.exit(main())
