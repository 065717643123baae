#!/usr/bin/env python3
"""Whether `torch.linalg.eigh` on a CUDA tensor can be captured in a CUDA
graph, and what one 12 x 12 eigensolve costs on the card and on the host.

    python3 tools/probe_eigh_capture.py

The capture runs in a child process of its own (a refused capture can
leave the process's cuSOLVER failing every later call), which also tries
one more eigh after it. The parent then times 50 uncaptured eigensolves
of a 12 x 12 SPD float32 matrix on the card and 50 on the host with the
round trip (copy to the host, eigh, eigenvectors back). Prints one JSON
line. Needs a CUDA card; imports only torch.
"""
import json
import subprocess
import sys
import time

import torch


def capture():
    out = {}
    G = torch.randn(12, 12, device="cuda")
    G = G @ G.T
    torch.linalg.eigh(G)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            torch.linalg.eigh(G)
        out["captured"] = True
    except Exception as e:  # noqa: BLE001 -- the probe reports whatever the capture raises
        out["captured"] = False
        out["capture_error"] = f"{type(e).__name__}: {str(e)[:300]}"
    try:
        torch.linalg.eigh(G)
        torch.cuda.synchronize()
        out["eigh_after_capture"] = "ok"
    except Exception as e:  # noqa: BLE001
        out["eigh_after_capture"] = f"{type(e).__name__}: {str(e)[:200]}"
    print(json.dumps(out), flush=True)


def main():
    if sys.argv[1:] == ["--child"]:
        capture()
        return
    r = subprocess.run([sys.executable, __file__, "--child"], capture_output=True, text=True)
    lines = r.stdout.strip().splitlines()
    out = {"phase": "eigh_capture", "device": torch.cuda.get_device_name(0),
           **(json.loads(lines[-1]) if lines else {"child_error": r.stderr[-1000:]})}
    G = torch.randn(12, 12, device="cuda")
    G = G @ G.T
    for where in ("cuda", "cpu"):
        for _ in range(3):
            torch.linalg.eigh(G if where == "cuda" else G.cpu())
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(50):
            if where == "cuda":
                torch.linalg.eigh(G)
            else:
                _, Q = torch.linalg.eigh(G.cpu())
                Q.to("cuda")
        torch.cuda.synchronize()
        out[f"eigh_{where}_us"] = (time.perf_counter() - t) / 50 * 1e6
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
