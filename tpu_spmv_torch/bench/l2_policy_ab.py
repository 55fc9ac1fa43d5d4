"""A/B of ``gpr_spmm`` (K6) with its X loads under an L2 eviction policy::

    for v in none last last-half last-half last none; do
        python3 tpu_spmv_torch/bench/l2_policy_ab.py --variant $v
    done

``none`` times this checkout's kernel.  ``last`` and ``last-half`` first
write a copy of the package under ``build/l2_policy/<variant>/`` whose
``gpr_spmm`` loads X with ``ld.global.nc.L2::cache_hint`` under a policy
from ``createpolicy.fractional``: ``L2::evict_last`` for every load, or
for half of them (``L2::evict_unchanged`` for the rest); nothing else
changes.  Each run builds its copy's kernels and prints one JSON line:
ms per call (CUDA events, median of 15 runs after warm-up) on the four
operands of ``bench/launch_ab.py`` (``random_sparse(100000, 7e-5)``,
``power_law(400000, 13)``, ``random_sparse(2000000, 8e-6)``, the
shuffled 2048x2048-grid Poisson) at 1, 3, 32 and 40 right-hand sides, a
hash of each output (a policy changes no bit), the card's name and power
limit.  Run the variants in the order above in one call, so that drift
in the card's speed falls on all of them.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]

#: createpolicy's qualifiers and fraction of each variant
POLICIES = {"last": ("L2::evict_last", "1.0"),
            "last-half": ("L2::evict_last.L2::evict_unchanged", "0.5")}

_LOAD = r'''
// X loads under an L2 eviction policy
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> ld_policy(const Pack<T, V>* p,
                                                uint64_t pol) {
  Pack<T, V> r;
  if constexpr (std::is_same<T, float>::value && V == 4)
    asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
        : "=f"(r.v[0]), "=f"(r.v[1]), "=f"(r.v[2]), "=f"(r.v[3])
        : "l"(p), "l"(pol));
  else if constexpr (std::is_same<T, float>::value && V == 2)
    asm("ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;"
        : "=f"(r.v[0]), "=f"(r.v[1]) : "l"(p), "l"(pol));
  else if constexpr (std::is_same<T, float>::value)
    asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
        : "=f"(r.v[0]) : "l"(p), "l"(pol));
  else if constexpr (V == 2)
    asm("ld.global.nc.L2::cache_hint.v2.f64 {%0, %1}, [%2], %3;"
        : "=d"(r.v[0]), "=d"(r.v[1]) : "l"(p), "l"(pol));
  else
    asm("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;"
        : "=d"(r.v[0]) : "l"(p), "l"(pol));
  return r;
}
'''


def _replace_once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"l2_policy_ab: general.cu has changed: {old!r}")
    return text.replace(old, new)


def make_variant(variant: str) -> Path:
    """Write the package with ``gpr_spmm``'s X loads under ``variant``'s
    policy to ``build/l2_policy/<variant>/``; return that root."""
    qualifiers, fraction = POLICIES[variant]
    root = _ROOT / "build" / "l2_policy" / variant
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_ROOT / "tpu_spmv_torch", root / "tpu_spmv_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = root / "tpu_spmv_torch" / "csrc" / "general.cu"
    text = src.read_text()
    anchor = "// gpr_spmm: entries whose X values a lane loads before"
    text = _replace_once(text, anchor, _LOAD + "\n" + anchor)
    loop = "  for (int q = threadIdx.x % G; q < xstride; q += G) {"
    text = _replace_once(
        text, "  const int64_t xstride = nrhs / V;\n" + loop,
        "  const int64_t xstride = nrhs / V;\n  uint64_t pol;\n"
        f'  asm("createpolicy.fractional.{qualifiers}.b64 %0, {fraction};"'
        ' : "=l"(pol));\n' + loop)
    text = _replace_once(
        text,
        "xv[i] = xp[static_cast<int64_t>(col[i]) * xstride + q];",
        "xv[i] = ld_policy<T, V>(\n"
        "              xp + static_cast<int64_t>(col[i]) * xstride + q, pol);")
    src.write_text(text)
    return root


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", choices=["none", *POLICIES], required=True)
    args = ap.parse_args(argv)
    root = _ROOT if args.variant == "none" else make_variant(args.variant)
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("l2_policy_ab: needs a CUDA card")
    import tpu_spmv_torch
    from tpu_spmv_torch import utils
    from tpu_spmv_torch.bench.launch_ab import event_ms
    from tpu_spmv_torch.kernels import gpr

    if Path(tpu_spmv_torch.__file__).resolve().parent.parent != root:
        raise SystemExit(f"l2_policy_ab: imported {tpu_spmv_torch.__file__}, "
                         f"not the package under {root}")
    dev = torch.device("cuda")
    out = {"variant": args.variant}
    lap = utils.laplacian_2d(2048)
    perm = np.random.default_rng(3).permutation(lap.shape[0])
    for label, make, iters in (
            ("100k", lambda: utils.random_sparse(100_000, 100_000, 7e-5,
                                                 seed=0), 40),
            ("power law", lambda: utils.power_law(400_000, 400_000, 13,
                                                  alpha=1.5, seed=6), 10),
            ("2M", lambda: utils.random_sparse(2_000_000, 2_000_000, 8e-6,
                                               seed=2), 10),
            ("shuffled 2048^2", lambda: lap[perm][:, perm].tocsr(), 10)):
        m = make()
        G = gpr.pack_gpr(m, dtype=torch.float32, device=dev)
        for nrhs in (1, 3, 32, 40):
            torch.manual_seed(nrhs)
            X = torch.rand(m.shape[1], nrhs, device=dev)
            Y = gpr.spmm_gpr_rows(G, X)
            out[f"{label} {nrhs} RHS hash"] = hashlib.sha1(
                Y.cpu().numpy().tobytes()).hexdigest()[:12]
            out[f"{label} {nrhs} RHS"] = event_ms(
                lambda: gpr.spmm_gpr_rows(G, X), iters, 15)
            del X, Y
        del G, m
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
