#!/usr/bin/env python3
"""Time the forms of an s-step CG trip's dense work on one card.

    python3 tools/time_sstep_forms.py [--n 192]

On n^3 float32 vectors of one part, for s = 2 and 4 (a basis of 2s + 1
vectors), by CUDA events (median of 20 after 3 warm calls):

* the basis laid out a point a row, ``(P, n, m)`` (`torch.stack` on the
  last axis), against a vector a row, ``(P, m, n)``, and that layout
  filled column by column from (P, n, 2) pair slabs, as
  `parallel/gpu.py:_make_sstep_cg_fn` fills it;
* the Gram matrix by one `torch.matmul` over the whole row in either
  layout, by `torch.einsum`, by m(m+1)/2 `torch.dot` calls, and by
  batched products of chunks of L rows summed over the chunks
  (`gpu._pgram_factory`, L = 2048, 8192, 32768);
* the product of the basis with a coordinate vector in either layout.

Prints one JSON line (milliseconds). Needs a CUDA card; imports only torch.
"""
import argparse
import json
import statistics

import torch


def t_ms(fn, reps=20):
    for _ in range(3):
        fn()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        ts.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(x.elapsed_time(y) for x, y in ts)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=192)
    n = ap.parse_args().n ** 3
    dev = "cuda"
    out = {"phase": "sstep_forms", "rows": n, "device": torch.cuda.get_device_name(0)}
    for s in (2, 4):
        m = 2 * s + 1
        cols = [torch.randn(1, n, device=dev) for _ in range(m)]
        slabs = [torch.randn(1, n, 2, device=dev) for _ in range(s)]
        c = torch.randn(m, device=dev)
        point_rows = torch.stack(cols, dim=-1)  # (P, n, m)
        V = torch.stack(cols, dim=1)  # (P, m, n)

        def fill():
            Vb = torch.empty(1, m, n, device=dev)
            Vb[:, 0] = slabs[0][..., 0]
            Vb[:, s + 1] = slabs[0][..., 1]
            for lev in range(s):
                Vb[:, lev + 1] = slabs[lev][..., 0]
                if lev < s - 1:
                    Vb[:, s + 2 + lev] = slabs[lev][..., 1]
            return Vb

        r = {
            "basis_bytes_MB": m * n * 4 / 1e6,
            "stack_point_rows": t_ms(lambda: torch.stack(cols, dim=-1)),
            "stack_vector_rows": t_ms(lambda: torch.stack(cols, dim=1)),
            "fill_vector_rows_from_pairs": t_ms(fill),
            "gram_point_rows_matmul": t_ms(lambda: torch.matmul(point_rows.transpose(1, 2), point_rows)),
            "gram_vector_rows_matmul": t_ms(lambda: torch.matmul(V, V.transpose(1, 2))),
            "gram_einsum": t_ms(lambda: torch.einsum("pin,pjn->ij", V, V)),
            "gram_dots": t_ms(lambda: [torch.dot(cols[i][0], cols[j][0]) for i in range(m) for j in range(i, m)]),
            "gemv_point_rows": t_ms(lambda: torch.matmul(point_rows, c)),
            "gemv_vector_rows": t_ms(lambda: torch.matmul(c, V)),
        }
        for L in (2048, 8192, 32768):
            C = n // L

            def chunked(L=L, C=C):
                Vc = V[0, :, : C * L].reshape(m, C, L).transpose(0, 1)
                G = torch.bmm(Vc, Vc.transpose(1, 2)).sum(dim=0)
                tail = V[0, :, C * L :]
                return G + tail @ tail.T

            r[f"gram_chunked_L{L}"] = t_ms(chunked)
        out[f"s={s}"] = r
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
