"""Time the bf16 attention kernels across batch sizes, beside SDPA.

Run from the repository root on a machine with one CUDA card:

    python3 attention_tiles.py                        # this checkout
    python3 attention_tiles.py --tiles 2,4 4,2 4,1    # forced block shapes
    python3 attention_tiles.py --package-root DIR ... # other trees

It holds the block-shape choice of csrc/attention_tc.cuh::tiles_for to
account. For each variant, at the encoder self-attention shape (T'=250,
4 heads, head_dim 128, bf16, key padding of a length-bucketed batch) and
B = 4, 8, 16, 32, 60 and 100 (the smoke's served and training batches up
to batches of the recipe's size), it checks the forward and the backward
against the plain version (chip_smoke.py's bf16 tolerances) and times
both and SDPA's forward and backward by CUDA-graph replay. It prints one
``attention_tiles`` JSON line a variant and fails if a check fails.

A variant is
  - this checkout's s2st_tpu_torch, with its own choice (no arguments);
  - ``--tiles W,S``: a copy of it under build/attention_tiles/ whose
    launchers take blocks of W warps (16 W rows) and S splits of the
    streamed loop at every grid;
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
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCHES = (4, 8, 16, 32, 60, 100)
T_ENC = 250
_LAUNCH_SHAPE = (r"(template <int NK>\ncudaError_t launch_shape\(const "
                 r"Params& p, int B, cudaStream_t stream\) \{\n)(.*?)"
                 r"(\n\}\n)")


def forced_copy(w: int, s: int, under: Path = REPO / "build") -> Path:
    """A copy of this checkout's package, under ``under``/attention_tiles,
    whose launchers always take the block shape (w, s)."""
    root = under / "attention_tiles" / f"w{w}s{s}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "s2st_tpu_torch", root / "s2st_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = root / "s2st_tpu_torch" / "csrc"
    bodies = {
        "flash_attention.cu":
            f"  return launch_tiles<{w}, {s}, NK>(p, B, stream);",
        "flash_attention_bwd.cu":
            f"  cudaError_t err = launch_dq<{w}, {s}, NK>(p, B, stream);\n"
            f"  if (err != cudaSuccess) return err;\n"
            f"  return launch_dkdv<{w}, {s}, NK>(p, B, stream);"}
    for name, body in bodies.items():
        path = csrc / name
        src, n = re.subn(_LAUNCH_SHAPE,
                         lambda m: m.group(1) + body + m.group(3),
                         path.read_text(), flags=re.S)
        if n != 1:
            raise AssertionError(f"{name}: no launch_shape to force")
        path.write_text(src)
    return root


def time_variant(root: Path, label: str) -> dict:
    """Check and time the attention kernels of the package under root."""
    import torch
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from s2st_tpu_torch.kernels import attention as ka
    if not Path(ka.__file__).resolve().is_relative_to(root.resolve()):
        raise AssertionError(f"imported {ka.__file__}, not under {root}")
    out = {"variant": label, "T": T_ENC, "H": cs.HEADS, "D": cs.HEAD_DIM,
           "forward": {}, "backward": {}}
    for b in BATCHES:
        lengths = [T_ENC - (25 * i) // b for i in range(b)]
        q, k, v, kpm = cs.attention_inputs(b, T_ENC, T_ENC, lengths,
                                           torch.bfloat16, seed=b)
        g = torch.randn(q.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(b)
                        ).to(torch.bfloat16)
        # forward against the plain version in bf16
        o = ka.flash_attention(q, k, v, kpm)
        err = float((o.float() - ka.flash_attention_reference(
            q, k, v, kpm).float()).abs().max())
        if not err <= cs.TOL_BF16:
            raise AssertionError(f"{label} B={b}: forward err {err}")
        # backward against the plain version's fp32 autograd
        o, m, lse = ka.flash_attention_forward(q, k, v, kpm, stats=True)
        got = ka.flash_attention_backward(q, k, v, o, m, lse, g, kpm)
        leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
        ka.flash_attention_reference(*leaves, kpm).backward(g.float())
        for name, x, ref in zip("qkv", got, leaves):
            e = float((x.float() - ref.grad).abs().max())
            if not e <= cs.TOL_BWD_BF16 * float(ref.grad.abs().max()):
                raise AssertionError(f"{label} B={b}: d{name} err {e}")
        out["forward"][b] = {
            "ms": cs.graph_ms(lambda: ka.flash_attention(q, k, v, kpm)),
            "sdpa_ms": cs.graph_ms(cs.sdpa_fn(q, k, v, kpm, False))}
        out["backward"][b] = {
            "ms": cs.graph_ms(lambda: ka.flash_attention_backward(
                q, k, v, o, m, lse, g, kpm)),
            "sdpa_ms": cs.grad_graph_ms(
                lambda *x: cs.sdpa_fn(*x, kpm, False)().transpose(1, 2),
                [x.detach().requires_grad_() for x in (q, k, v)], g)}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tiles", nargs="*", default=[],
                        help="forced block shapes W,S")
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
            time_variant(Path(args.one[0]), args.one[1])), flush=True)
        return 0
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    card = cs.gpu_identity()
    print(f"gpu: {card}", flush=True)
    variants = [(REPO, "this checkout")] if not (args.tiles or
                                                 args.package_root) else []
    for spec in args.tiles:
        w, s = (int(x) for x in spec.split(","))
        variants.append((forced_copy(w, s), f"tiles {w},{s}"))
    variants += [(p.resolve(), str(p)) for p in args.package_root]
    t0 = time.perf_counter()
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from s2st_tpu_torch.kernels import nvcc; nvcc.build(["
         "'flash_attention', 'flash_attention_bwd'])", str(root)])
        for root in {root for root, _ in variants}]
    if any([p.wait() for p in builds]):
        raise SystemExit("attention_tiles: a build failed")
    print(f"built {len(builds)} trees in {time.perf_counter() - t0:.1f} s",
          flush=True)
    failed = [label for root, label in variants
              if subprocess.run([sys.executable, __file__, "--one",
                                 str(root), label]).returncode]
    print(f"gpu: {card}", flush=True)
    if failed:
        print(f"attention_tiles: failed: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
