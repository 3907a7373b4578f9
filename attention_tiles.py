"""Time the attention kernels across batch sizes, beside SDPA.

Run from the repository root on a machine with one CUDA card:

    python3 attention_tiles.py                        # this checkout, bf16
    python3 attention_tiles.py --dtype float32        # the fp32 design
    python3 attention_tiles.py --tiles 2,4 4,2 4,1    # forced block shapes
    python3 attention_tiles.py --dtype float32 --fp32-tiles 64,32 32,32
    python3 attention_tiles.py --dtype float32 --fp32-bwd-tiles 64,16,64,16,16
    python3 attention_tiles.py --package-root DIR ... # other trees

It holds the block-shape choices of csrc/attention_tc.cuh::tiles_for (bf16),
of csrc/flash_attention.cu's fp32 forward and of
csrc/flash_attention_bwd.cu's fp32 backward to account. For each variant, at the encoder
self-attention shape (T'=250, 4 heads, head_dim 128, key padding of a
length-bucketed batch) and B = 4, 8, 16, 32, 60 and 100 (the smoke's
served and training batches up to batches of the recipe's size), and at
the HuBERT frontend's (B=16, T'=511 keys of which 199-499 are valid, 12
heads, head_dim 64), it checks the forward and the backward against the
plain version (chip_smoke.py's tolerances for the type) and times both,
SDPA's forward and backward by CUDA-graph replay, beside the bound
(chip_smoke.attention_bound_ms). It prints one ``attention_tiles`` JSON
line a variant and fails if a check fails.

A variant is
  - this checkout's s2st_tpu_torch, with its own choice (no arguments);
  - ``--tiles W,S``: a copy of it under build/attention_tiles/ whose bf16
    launchers take blocks of W warps (16 W rows) and S splits of the
    streamed loop at every grid;
  - ``--fp32-tiles R,K``: a copy whose fp32 forward takes blocks of R
    queries and streams K-key tiles at every grid;
  - ``--fp32-bwd-tiles RQ,GQ,RK,GK[,T]``: a copy whose fp32 backward
    takes blocks of RQ queries in GQ row groups (8 GQ threads) for dQ and
    of RK keys in GK row groups for dK/dV, and streams tiles of T rows (32
    by default), at every grid;
  - ``--package-root DIR``: the s2st_tpu_torch under DIR, through its
    wrapper's functions only, so an older tree (git archive of a parent)
    can be timed beside this one: parent, change, change, parent.
Each variant runs in its own process; the copies are built in parallel.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCHES = (4, 8, 16, 32, 60, 100)
T_ENC = 250
_LAUNCH_SHAPE = (r"(template <int NK>\ncudaError_t launch_shape\(const "
                 r"Params& p, int B, cudaStream_t stream\) \{\n)(.*?)"
                 r"(\n\}\n)")
_FP32_KEYS = r"(namespace fp32 \{.*?constexpr int kKeys = )\d+"
_FP32_ROWS = (r"(inline int rows_for\(int bh, int Tq\) \{\n)(.*?)"
              r"(\n\}\n)")
_FP32_BWD_SHAPES = (r"(template <int Dp>\ncudaError_t launch_shapes\(const "
                    r"Params& p, int B, cudaStream_t stream\) \{\n)(.*?)"
                    r"(\n\}\n)")


def _copy(name: str, under: Path) -> Path:
    """A copy of this checkout's package under ``under``/attention_tiles/
    ``name``; returns the copy's root."""
    root = under / "attention_tiles" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "s2st_tpu_torch", root / "s2st_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def _sub_once(path: Path, pattern: str, repl) -> None:
    src, n = re.subn(pattern, repl, path.read_text(), flags=re.S)
    if n != 1:
        raise AssertionError(f"{path.name}: {pattern!r} matched {n} times")
    path.write_text(src)


def forced_copy(w: int, s: int, under: Path = REPO / "build") -> Path:
    """A copy of this checkout's package, under ``under``/attention_tiles,
    whose bf16 launchers always take the block shape (w, s)."""
    root = _copy(f"w{w}s{s}", under)
    csrc = root / "s2st_tpu_torch" / "csrc"
    bodies = {
        "flash_attention.cu":
            f"  return launch_tiles<{w}, {s}, NK>(p, B, stream);",
        "flash_attention_bwd.cu":
            f"  cudaError_t err = launch_dq<{w}, {s}, NK>(p, B, stream);\n"
            f"  if (err != cudaSuccess) return err;\n"
            f"  return launch_dkdv<{w}, {s}, NK>(p, B, stream);"}
    for name, body in bodies.items():
        _sub_once(csrc / name, _LAUNCH_SHAPE,
                  lambda m, body=body: m.group(1) + body + m.group(3))
    return root


def fp32_copy(r: int, k: int, under: Path = REPO / "build") -> Path:
    """A copy whose fp32 forward always takes blocks of r queries and
    streams k-key tiles."""
    root = _copy(f"fp32_r{r}k{k}", under)
    path = root / "s2st_tpu_torch" / "csrc" / "flash_attention.cu"
    _sub_once(path, _FP32_KEYS, lambda m: m.group(1) + str(k))
    _sub_once(path, _FP32_ROWS,
              lambda m: m.group(1) + f"  return {r};" + m.group(3))
    return root


def fp32_bwd_copy(rq: int, gq: int, rk: int, gk: int, t: int = 32,
                  under: Path = REPO / "build") -> Path:
    """A copy whose fp32 backward always takes blocks of rq queries in gq
    row groups (dQ) and of rk keys in gk row groups (dK/dV), and streams
    tiles of t rows."""
    root = _copy(f"fp32_bwd_q{rq}g{gq}_k{rk}g{gk}_t{t}", under)
    path = root / "s2st_tpu_torch" / "csrc" / "flash_attention_bwd.cu"
    body = (f"  cudaError_t err = launch_dq_fp32<Dp, {rq}, {gq}, {t}>(p, B, "
            f"stream);\n  if (err != cudaSuccess) return err;\n"
            f"  return launch_dkdv_fp32<Dp, {rk}, {gk}, {t}>(p, B, stream);")
    _sub_once(path, _FP32_BWD_SHAPES, lambda m: m.group(1) + body + m.group(3))
    return root


def shapes(cs) -> list:
    """(label, B, T, H, D, key lengths): the encoder self-attention at each
    batch size, then the HuBERT frontend's self-attention."""
    out = [(str(b), b, T_ENC, cs.HEADS, cs.HEAD_DIM,
            [T_ENC - (25 * i) // b for i in range(b)]) for b in BATCHES]
    lengths, t = cs.hubert_lengths()
    out.append(("hubert", len(lengths), t, cs.HUBERT_HEADS,
                cs.HUBERT_HEAD_DIM, lengths))
    return out


def within(got, ref, dtype, cs, backward=False) -> bool:
    """chip_smoke.py's tolerance for the type: fp32 elementwise atol +
    rtol; bf16 an atol (forward) or a share of the largest magnitude
    (backward)."""
    err = (got.float() - ref.float()).abs()
    if dtype == "float32":
        atol, rtol = cs.TOL_BWD_FP32 if backward else cs.TOL_FP32
        return bool((err <= atol + rtol * ref.float().abs()).all())
    if backward:
        return float(err.max()) <= cs.TOL_BWD_BF16 * float(ref.abs().max())
    return float(err.max()) <= cs.TOL_BF16


def time_variant(root: Path, label: str, dtype: str) -> dict:
    """Check and time the attention kernels of the package under root."""
    import torch
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from s2st_tpu_torch.kernels import attention as ka
    if not Path(ka.__file__).resolve().is_relative_to(root.resolve()):
        raise AssertionError(f"imported {ka.__file__}, not under {root}")
    dt = getattr(torch, dtype)
    out = {"variant": label, "dtype": dtype, "forward": {}, "backward": {}}
    for name, b, t, h, d, lengths in shapes(cs):
        q, k, v, kpm = cs.attention_inputs(b, t, t, lengths, dt, seed=b,
                                           d=d, h=h)
        g = torch.randn(q.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(b)
                        ).to(dt)
        # forward against the plain version in the type
        o = ka.flash_attention(q, k, v, kpm)
        if not within(o, ka.flash_attention_reference(q, k, v, kpm), dtype,
                      cs):
            raise AssertionError(f"{label} {name} {dtype}: forward err")
        # backward against the plain version's fp32 autograd
        o, m, lse = ka.flash_attention_forward(q, k, v, kpm, stats=True)
        got = ka.flash_attention_backward(q, k, v, o, m, lse, g, kpm)
        leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
        ka.flash_attention_reference(*leaves, kpm).backward(g.float())
        for x, ref in zip(got, leaves):
            if not within(x, ref.grad, dtype, cs, backward=True):
                raise AssertionError(f"{label} {name} {dtype}: gradient "
                                     f"err")
        shape = {"B": b, "T": t, "H": h, "D": d}
        bound, by = cs.attention_bound_ms(q, k, kpm, False)
        out["forward"][name] = {
            **shape,
            "ms": cs.graph_ms(lambda: ka.flash_attention(q, k, v, kpm)),
            "sdpa_ms": cs.graph_ms(cs.sdpa_fn(q, k, v, kpm, False)),
            "bound_ms": bound, "bound_by": by}
        bound, by = cs.attention_bound_ms(q, k, kpm, False, backward=True)
        out["backward"][name] = {
            **shape,
            "ms": cs.graph_ms(lambda: ka.flash_attention_backward(
                q, k, v, o, m, lse, g, kpm)),
            "sdpa_ms": cs.grad_graph_ms(
                lambda *x: cs.sdpa_fn(*x, kpm, False)().transpose(1, 2),
                [x.detach().requires_grad_() for x in (q, k, v)], g),
            "bound_ms": bound, "bound_by": by}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dtype", choices=("bfloat16", "float32"),
                        default="bfloat16", help="the inputs' type")
    parser.add_argument("--tiles", nargs="*", default=[],
                        help="forced bf16 block shapes W,S")
    parser.add_argument("--fp32-tiles", nargs="*", default=[],
                        help="forced fp32 forward blocks R,K (queries, "
                             "keys a tile)")
    parser.add_argument("--fp32-bwd-tiles", nargs="*", default=[],
                        help="forced fp32 backward blocks RQ,GQ,RK,GK[,T] "
                             "(rows and row groups of dQ, then of dK/dV; "
                             "rows of a streamed tile)")
    parser.add_argument("--package-root", nargs="*", type=Path, default=[],
                        help="trees whose s2st_tpu_torch to time")
    parser.add_argument("--one", nargs=2, metavar=("ROOT", "LABEL"),
                        help=argparse.SUPPRESS)  # one variant, this process
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("attention_tiles: CUDA is not available", file=sys.stderr)
        return 1
    if args.one:
        print("attention_tiles " + json.dumps(
            time_variant(Path(args.one[0]), args.one[1], args.dtype)),
            flush=True)
        return 0
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    card = cs.gpu_identity()
    print(f"gpu: {card}", flush=True)
    variants = [(REPO, "this checkout")] if not (
        args.tiles or args.fp32_tiles or args.fp32_bwd_tiles
        or args.package_root) else []
    for spec in args.tiles:
        w, s = (int(x) for x in spec.split(","))
        variants.append((forced_copy(w, s), f"tiles {w},{s}"))
    for spec in args.fp32_tiles:
        r, k = (int(x) for x in spec.split(","))
        variants.append((fp32_copy(r, k), f"fp32 tiles {r},{k}"))
    for spec in args.fp32_bwd_tiles:
        shape = [int(x) for x in spec.split(",")]
        variants.append((fp32_bwd_copy(*shape),
                         f"fp32 bwd tiles {spec}"))
    variants += [(p.resolve(), str(p)) for p in args.package_root]
    if not cs.build_trees([root for root, _ in variants],
                          ["flash_attention", "flash_attention_bwd"]):
        raise SystemExit("attention_tiles: a build failed")
    failed = [label for root, label in variants
              if subprocess.run([sys.executable, __file__, "--dtype",
                                 args.dtype, "--one", str(root),
                                 label]).returncode]
    print(f"gpu: {card}", flush=True)
    if failed:
        print(f"attention_tiles: failed: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
