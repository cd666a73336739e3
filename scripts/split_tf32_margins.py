#!/usr/bin/env python3
"""How much of the f32 gradient tolerance the split-TF32 flash backward
uses, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 scripts/split_tf32_margins.py

For each f32 case of ``tests/test_torch_flash_attention.py`` (the JAX
package's Pallas ``flash_attention`` VJP in interpret mode on numpy
inputs from a seed), the emulated arithmetic of the f32 dq and dk/dv
kernels (``tests/torch_split_tf32.py``: three TF32 products a product,
and one for contrast) is held against JAX's dq, dk and dv. Prints, per
case, the worst |got - want| / (atol + rtol |want|) of each gradient at
the tests' 5e-5: a share below 1 passes, above 1 misses. One JSON line
per case.
"""

import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tests"))
import test_torch_flash_attention as t  # noqa: E402
from torch_split_tf32 import split_tf32_backward  # noqa: E402


def main() -> None:
    for case in t.F32_CASES:
        name, _, causal, window, _, _, q_off, k_off, dtype = case
        arrays, (o, lse, *want) = t.case_data(case)
        q, k, v, do = (t.to_torch(a) for a in arrays)
        delta = t.fa.attention_delta(torch.tensor(o), do)
        args = (q, k, v, do, torch.tensor(lse), delta, q_off, k_off, causal)
        tol = t.TOL[dtype][1]
        shares = {}
        for products in (3, 1):
            got = split_tf32_backward(*args, products, window)
            shares[products] = [
                float((np.abs(g.numpy() - w) / (tol + tol * np.abs(w))).max())
                for g, w in zip(got, want)]
        print(json.dumps({"case": name, "tol": tol,
                          "three_products": shares[3],
                          "one_product": shares[1]}))


if __name__ == "__main__":
    main()
