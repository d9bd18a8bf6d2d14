"""Shared CLI flag parser — parity with the reference's process_args.

Mirrors getopt_long options (nlibs/process_args.h:26-41, process_args.cc:
5-114): ``--input/-i``, ``--rmclOptions/-r``, ``--maxIters/-m``,
``--stride/-d``, ``--stats/-s``, ``--br/--bc`` block dims, ``--ptile``,
``--calcChange/-c``; the GPU cache flag ``--shared/-e`` becomes a no-op
accepted for script compatibility.
"""

from __future__ import annotations

import argparse

from ..config import DEFAULT_MAX_ITERS, DEFAULT_STRIDE


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--input", "-i", required=True, help="SNAP or MatrixMarket file")
    p.add_argument(
        "--rmclOptions",
        "-r",
        default="ESC",
        help="backend name (SEQ/OMP/GPU/CILK/SOMP/MKL/SFOMP/HYB all map "
        "onto the device ESC kernel; qrmcl.h:8-21 parity)",
    )
    p.add_argument("--maxIters", "-m", type=int, default=DEFAULT_MAX_ITERS)
    p.add_argument(
        "--stride",
        "-d",
        type=int,
        default=DEFAULT_STRIDE,
        help="accepted for parity; XLA owns tiling",
    )
    p.add_argument("--stats", "-s", action="store_true", help="per-iteration stats")
    p.add_argument("--calcChange", "-c", action="store_true")
    p.add_argument("--shared", "-e", default="None", help="no-op (GPU cache flag)")
    p.add_argument(
        "--ptile", type=int, default=0,
        help="accepted for parity (process_args.h); consumed by nothing",
    )
    p.add_argument(
        "--br", type=int, default=8,
        help="block rows — accepted for parity; BCSR callers size blocks "
        "directly (default 8)",
    )
    p.add_argument(
        "--bc", type=int, default=128,
        help="block cols — accepted for parity; BCSR callers size blocks "
        "directly (default 128)",
    )
    return p


def print_args(args) -> None:
    """Echo flags like print_args (process_args.cc:103-114)."""
    for k, v in sorted(vars(args).items()):
        print(f"{k} = {v}")
