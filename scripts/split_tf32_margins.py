#!/usr/bin/env python3
"""How much of the f32 tolerances the split-TF32 flash forward and
backward use, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 scripts/split_tf32_margins.py

For each f32 case of ``tests/test_torch_flash_attention.py`` (the JAX
package's Pallas ``flash_attention``, its forward's lse and its VJP in
interpret mode on numpy inputs from a seed), the emulated arithmetic of
the f32 kernels (``tests/torch_split_tf32.py``: three TF32 products a
product, and one for contrast) is held against JAX's o and lse at the
forward's 2e-5 and against its dq, dk and dv at the gradients' 5e-5.
Prints, per case, the worst |got - want| / (atol + rtol |want|) of each
output at its tolerance: a share below 1 passes, above 1 misses. One
JSON line per case, the forward's shares as [o, lse], the backward's as
[dq, dk, dv].
"""

import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tests"))
import test_torch_flash_attention as t  # noqa: E402
from torch_split_tf32 import (split_tf32_backward,  # noqa: E402
                              split_tf32_flash_forward)


def main() -> None:
    for case in t.F32_CASES:
        name, _, causal, window, _, _, q_off, k_off, dtype = case
        arrays, (o, lse, *want) = t.case_data(case)
        q, k, v, do = (t.to_torch(a) for a in arrays)
        delta = t.fa.attention_delta(torch.tensor(o), do)
        args = (q, k, v, do, torch.tensor(lse), delta, q_off, k_off, causal)
        tol_fwd, tol = t.TOL[dtype]
        shares, fwd = {}, {}
        for products in (3, 1):
            got = split_tf32_backward(*args, products, window)
            shares[products] = share(got, want, tol)
            got = split_tf32_flash_forward(q, k, v, q_off, k_off, causal,
                                           products, window)
            fwd[products] = share(got, (o, lse), tol_fwd)
        print(json.dumps({"case": name, "tol_forward": tol_fwd,
                          "forward_three_products": fwd[3],
                          "forward_one_product": fwd[1], "tol": tol,
                          "three_products": shares[3],
                          "one_product": shares[1]}))


def share(got, want, tol: float) -> list:
    """Per output, the worst |got - want| / (tol + tol |want|)."""
    return [float((np.abs(g.numpy() - w) / (tol + tol * np.abs(w))).max())
            for g, w in zip(got, want)]


if __name__ == "__main__":
    main()
