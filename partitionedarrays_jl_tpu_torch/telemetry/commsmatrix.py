"""The measured per-edge, per-round exchange cost matrix
(telemetry/commsmatrix.py of the JAX package).

`telemetry.comms` counts an exchange's rounds and per-part bytes; this
module records what each edge of the plan costs:

* **Static side** — `static_matrix` walks the plan's round schedule (the
  generic plan's colour rounds, ``DeviceExchangePlan.perms``; the box
  plan's directions) into per-edge rows: sender part, receiver part,
  payload slots (the real ghost entries), wire slots (the padded slab the
  round moves), bytes of each. The per-round totals must reconcile exactly
  with `comms._exchange_inventory` (`reconcile_matrix`), the accounting
  every record carries.
* **Measured side** — `measure_comms_matrix` times each round of the
  generic plan (`gpu.exchange_round_`) and each direction of the box plan
  (that direction's moves alone, `gpu_box.box_exchange_` over the
  direction's slots) as its own chain, by the marginal protocol
  (`profile.marginal_s`: two trip counts, differenced; on the card each
  chain a CUDA graph timed by events after an L2 flush and a queued spin,
  on the CPU `time.perf_counter`), then splits each round's time over its
  edges by payload share. The box plan's directions are separate index
  moves in the port (the JAX package's fused slice program attributes its
  directions by bytes, ``attribution="proportional"``), so they are timed
  apart (``attribution="measured-direction"``); the whole exchange is
  timed too (``full_exchange_s``): the plan moves every direction in one
  gather and one copy, plus the fill of the ghost slots no direction
  covers, which no direction's chain holds.
* **Fabric labels** — ``self`` (an edge from a part to itself) and
  ``card`` (two parts on one card, `classify_edge`). The cross-card labels
  come with the multi-card plans.

The fabric fit (`fit_fabric_model`) fits each measured fabric's latency
and per-byte cost from the matrix alone; a fabric with fewer than two
distinct payload sizes gets no fit (``source`` ``"too few sizes"``): the
port keeps no prior figures.
"""
from __future__ import annotations

from typing import List, Optional

__all__ = [
    "COMMS_MATRIX_SCHEMA_VERSION",
    "classify_edge",
    "fabric_summary",
    "fit_fabric_model",
    "static_matrix",
    "reconcile_matrix",
    "measure_comms_matrix",
    "render_comms_matrix",
]

#: the JAX package's schema version (edge rows carry ``tier``, the record
#: carries ``fabric_summary``)
COMMS_MATRIX_SCHEMA_VERSION = 2


def classify_edge(src: int, dst: int) -> str:
    """The fabric of one exchange edge on one card: ``self`` (a part to
    itself) or ``card`` (two parts stacked on one card)."""
    return "self" if src == dst else "card"


def fabric_summary(edges) -> dict:
    """The per-fabric rollup, recomputed from the edge rows."""
    out: dict = {}
    for e in edges:
        s = out.setdefault(e["fabric"], {"edges": 0, "payload_bytes": 0, "wire_bytes": 0, "measured_s": 0.0})
        s["edges"] += 1
        s["payload_bytes"] += int(e["payload_bytes"])
        s["wire_bytes"] += int(e["wire_bytes"])
        s["measured_s"] = round(s["measured_s"] + float(e.get("measured_s") or 0.0), 12)
    return out


def fit_fabric_model(matrix: dict) -> dict:
    """Per fabric of the matrix's measured edges, the least-squares fit of
    ``measured_s ~ alpha_s + beta_s_per_byte * payload_bytes``
    (``source`` ``"fit"``); a fabric with fewer than two distinct payload
    sizes cannot separate latency from bandwidth and gets ``None`` for both
    (``source`` ``"too few sizes"``)."""
    import numpy as np

    by_fabric: dict = {}
    for e in matrix.get("edges", ()):
        if e.get("measured_s") is not None:
            by_fabric.setdefault(e["fabric"], []).append((float(e["payload_bytes"]), float(e["measured_s"])))
    model = {}
    for fabric, pts in sorted(by_fabric.items()):
        if len({b for b, _ in pts}) >= 2:
            b = np.array([p[0] for p in pts])
            t = np.array([p[1] for p in pts])
            (alpha, beta), *_ = np.linalg.lstsq(np.stack([np.ones_like(b), b], axis=1), t, rcond=None)
            model[fabric] = {"alpha_s": max(float(alpha), 0.0), "beta_s_per_byte": max(float(beta), 0.0),
                             "source": "fit", "points": len(pts)}
        else:
            model[fabric] = {"alpha_s": None, "beta_s_per_byte": None, "source": "too few sizes",
                             "points": len(pts)}
    return model


def _plan_rounds(plan):
    """Any plan as ``[(wire_slots, [(src, dst, payload_slots), ...],
    tier), ...]``, ``tier`` ``"direct"``: the generic plan's rounds (the
    padded slab of ``L`` slots, each edge's real slots its sender's mask),
    the box plan's directions (each edge the direction's segment)."""
    import numpy as np

    from ..parallel.gpu_box import BoxExchangePlan

    if isinstance(plan, BoxExchangePlan):
        return [(int(d.size), [(int(p), int(q), int(d.size)) for p, q in d.perm], "direct")
                for d in plan.info.dirs]
    L = int(plan.snd_idx.shape[-1])
    mask = plan.snd_mask.cpu().numpy()
    return [(L, [(int(s), int(d), int(np.count_nonzero(mask[r, s]))) for s, d in perm], "direct")
            for r, perm in enumerate(plan.perms)]


def static_matrix(plan, dtype, K: int = 1) -> dict:
    """The plan's half of the matrix: per-round, per-edge byte accounting
    (no timing), each edge labelled by `classify_edge`."""
    import numpy as np

    from ..parallel.gpu_box import BoxExchangePlan

    itemsize = int(np.dtype(dtype).itemsize)
    K = max(1, int(K))
    P = plan.layout.P
    rounds = _plan_rounds(plan)
    edges: List[dict] = []
    per_device_bytes = 0
    for r, (wire_slots, edge_list, tier) in enumerate(rounds):
        per_device_bytes += wire_slots * K * itemsize
        for src, dst, payload in edge_list:
            edges.append({
                "round": r, "tier": tier, "src": src, "dst": dst, "fabric": classify_edge(src, dst),
                "payload_slots": payload, "wire_slots": wire_slots,
                "payload_bytes": payload * K * itemsize, "wire_bytes": wire_slots * K * itemsize,
            })
    return {
        "comms_matrix_schema_version": COMMS_MATRIX_SCHEMA_VERSION,
        "plan": "box" if isinstance(plan, BoxExchangePlan) else "generic",
        "P": int(P),
        "K": K,
        "dtype": str(np.dtype(dtype)),
        "rounds": len(rounds),
        "round_tiers": [t for _, _, t in rounds],
        "edges": edges,
        "fabric_summary": fabric_summary(edges),
        "static": {"ops": len(rounds), "per_device_bytes": per_device_bytes},
    }


def reconcile_matrix(matrix: dict, dA, abft: bool = False) -> list:
    """A matrix (fresh or loaded) against `comms._exchange_inventory` of
    ``dA``'s plan. Returns mismatch strings (empty: they agree)."""
    import numpy as np

    from .comms import _exchange_inventory

    if matrix.get("comms_matrix_schema_version") != COMMS_MATRIX_SCHEMA_VERSION:
        return [f"comms_matrix_schema_version {matrix.get('comms_matrix_schema_version')!r} != "
                f"{COMMS_MATRIX_SCHEMA_VERSION}"]
    out = []
    ops, nbytes = _exchange_inventory(dA, abft, int(matrix["K"]), np.dtype(matrix["dtype"]).itemsize)
    if matrix["static"]["ops"] != ops:
        out.append(f"rounds: matrix {matrix['static']['ops']} != _exchange_inventory {ops}")
    if matrix["static"]["per_device_bytes"] != nbytes:
        out.append(f"per-device bytes: matrix {matrix['static']['per_device_bytes']} != _exchange_inventory {nbytes}")
    by_round: dict = {}
    for e in matrix["edges"]:
        by_round.setdefault(e["round"], []).append(e)
    if sorted(by_round) != list(range(matrix["rounds"])):
        out.append(f"edge rows cover rounds {sorted(by_round)} but the matrix declares {matrix['rounds']} rounds")
    for r, edges in by_round.items():
        wires = {e["wire_slots"] for e in edges}
        if len(wires) != 1:
            out.append(f"round {r}: inconsistent wire slots {wires}")
        for e in edges:
            if e["payload_slots"] > e["wire_slots"]:
                out.append(f"round {r} edge {e['src']}->{e['dst']}: payload {e['payload_slots']} exceeds wire "
                           f"{e['wire_slots']}")
    summary = matrix.get("fabric_summary")
    if summary is not None and summary != fabric_summary(matrix["edges"]):
        out.append("fabric_summary does not recompute from the edge rows")
    return out


def _round_steps(plan) -> list:
    """One step function a round of the plan: a generic round
    (`gpu.exchange_round_`), or a box direction's moves alone (the
    direction's slots of the plan's flat move list, `gpu_box.box_exchange_`
    over a plan holding those only)."""
    import math
    import importlib

    from ..parallel.gpu_box import BoxExchangePlan, box_exchange_

    g = importlib.import_module("..parallel.gpu", __package__)
    if not isinstance(plan, BoxExchangePlan):
        return [lambda xv, _r=r: g.exchange_round_(plan, _r, xv) for r in range(plan.R)]
    info = plan.info
    steps, a = [], 0
    for d in info.dirs:
        b = a + sum(math.prod(d.geo[int(info.variants[p])][1]) for p, _ in d.perm)
        sub = BoxExchangePlan(plan.layout, info, None, False,
                              (plan.src[a:b], plan.dst[a:b], None, plan.add_src, plan.add_rounds))
        steps.append(lambda xv, _s=sub: box_exchange_(_s, xv, "set"))
        a = b
    return steps


def measure_comms_matrix(A, backend, dtype=None, K: int = 1, k1: int = 8, k2: int = 64, reps: Optional[int] = None,
                         box: bool = True) -> dict:
    """The whole matrix of ``A``'s column plan on ``backend`` (the box plan,
    or the generic one with ``box=False``): `static_matrix`, each round's
    (direction's) marginal seconds as its own chain (``round_s``, split over
    its edges by payload share into ``measured_s``), their sum
    (``exchange_s``) and the whole exchange's own chain
    (``full_exchange_s``). ``dtype`` defaults to A's; ``reps`` to the
    config's ``prof_reps``."""
    import importlib

    import numpy as np
    import torch

    from .config import config
    from .profile import chain_timer, marginal_s
    from .throughput import operator_fingerprint

    g = importlib.import_module("..parallel.gpu", __package__)
    dtype = np.dtype(A.dtype if dtype is None else dtype)
    reps = max(3, int(config().prof_reps if reps is None else reps))
    dA = g.device_matrix(A, backend, box)
    plan = dA.col_plan
    matrix = static_matrix(plan, dtype, K=K)
    matrix["fingerprint"] = operator_fingerprint(A)
    matrix["trips"] = {"k1": int(k1), "k2": int(k2), "reps": int(reps)}
    L = plan.layout
    shape = (L.P, L.W, K) if K > 1 else (L.P, L.W)
    x = torch.zeros(shape, dtype=getattr(torch, dtype.name), device=backend.device)
    x[:, L.o0 : L.g0] = 1.0
    round_s = [marginal_s(chain_timer(lambda _st=st: _st(x), x.device), k1, k2, reps) for st in _round_steps(plan)]
    matrix["attribution"] = "measured-direction" if matrix["plan"] == "box" else "measured-round"
    if matrix["plan"] == "box":
        matrix["direction_note"] = ("each direction timed as its own index move; the plan moves every direction "
                                    "in one gather and one copy and fills the uncovered ghost slots")
    for e in matrix["edges"]:
        peers = [p for p in matrix["edges"] if p["round"] == e["round"]]
        payload_total = sum(p["payload_bytes"] for p in peers)
        share = e["payload_bytes"] / payload_total if payload_total else 1.0 / len(peers)
        e["measured_s"] = round(round_s[e["round"]] * share, 12)
    matrix["round_s"] = [round(v, 12) for v in round_s]
    matrix["exchange_s"] = round(sum(round_s), 12)
    matrix["full_exchange_s"] = round(
        marginal_s(chain_timer(lambda: g.exchange_(plan, x), x.device), k1, k2, reps) if round_s else 0.0, 12)
    matrix["fabric_summary"] = fabric_summary(matrix["edges"])
    matrix["fabric_model"] = fit_fabric_model(matrix)
    matrix["static_check"] = reconcile_matrix(matrix, dA)
    return matrix


def render_comms_matrix(matrix: dict) -> str:
    """The operator-facing table: one line per edge, by round."""
    lines = [
        f"comms matrix: operator={matrix.get('fingerprint', '?')} plan={matrix['plan']} P={matrix['P']} "
        f"K={matrix['K']} dtype={matrix['dtype']} rounds={matrix['rounds']} "
        f"(attribution: {matrix.get('attribution', 'static-only')})"
    ]
    for e in matrix["edges"]:
        t = e.get("measured_s")
        bw = f"  {e['payload_bytes'] / t / 1e6:10.2f} MB/s" if t else ""
        lines.append(
            f"  round {e['round']}: {e['src']:>2} -> {e['dst']:<2} [{e['fabric']:>4}/{e.get('tier', 'direct'):<7}] "
            f"payload {e['payload_bytes']:>8} B / wire {e['wire_bytes']:>8} B"
            + (f"  {t * 1e6:10.2f} us" if t is not None else "") + bw
        )
    for fabric, s in sorted((matrix.get("fabric_summary") or {}).items()):
        lines.append(f"  [{fabric}] {s['edges']} edges, payload {s['payload_bytes']} B, wire {s['wire_bytes']} B, "
                     f"{s['measured_s'] * 1e6:.2f} us")
    if matrix.get("exchange_s") is not None:
        lines.append(f"  rounds summed: {matrix['exchange_s'] * 1e6:.2f} us/halo; whole exchange "
                     f"{matrix['full_exchange_s'] * 1e6:.2f} us/halo, {matrix['static']['per_device_bytes']} B/part")
    check = matrix.get("static_check")
    if check is not None:
        lines.append("  static reconciliation vs comms inventory: " + ("OK" if not check else "; ".join(check)))
    return "\n".join(lines)
