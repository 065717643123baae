"""The front door on the card (frontdoor/ of the JAX package): the
multi-tenant layer that makes one process look like a service (many
operators, many clients, deadlines, graceful behavior under overload). It
composes over the in-process `service.SolveService`, never reaching into
it:

* `frontdoor.tenancy`  — `OperatorRegistry`: N named operators admitted
  against a memory budget (the JAX package's structural footprint), routed
  to per-tenant `SolveService`s, with LRU paging: a page-out drains the
  tenant's slabs through the service's checkpoint path and drops its
  device staging, solve functions and CUDA graphs; the next request pages
  it back in.
* `frontdoor.scheduler` — `Gate`: the EDF cross-tenant queue and SLO-class
  load shedding (`LoadShedded`, distinct from `AdmissionRejected`), spectrum
  deadline admission (`DeadlineInfeasible`), idempotency keys,
  `Gate.recover()` and `Gate.adopt()`.
* `frontdoor.journal`  — `RequestJournal`: the CRC'd, fsync'd JSONL
  write-ahead journal, record for record the JAX package's format.
* `frontdoor.rpc`      — `GateServer`, `http_solve`: the stdlib HTTP/JSON
  surface with exact-float serialization.
* `frontdoor.fleet`    — replicas behind rendezvous routing, CRC'd lease
  heartbeats and journal-backed failover (host only).
* `frontdoor.config`   — `GateConfig`, the switches the JAX package reads
  from ``PA_GATE_*``, ``PA_FLEET_*`` and ``PA_RETRY_JITTER``, set by
  `configure`; the port reads no environment.

Threads and the card: tenants on one card take turns through its
`service.device_lock` (a slab, and a page-out, hold it), so one tenant's
CUDA-graph capture never sees another's work; HTTP handler threads, the
gate's pump and the fleet's heartbeat keep host arrays only.
"""
from .config import GateConfig, config, configure  # noqa: F401
from .fleet import (  # noqa: F401
    FleetMap,
    FleetMember,
    LeaseCorruptError,
    fleet_lease_s,
    fleet_replicas,
    read_lease,
    rendezvous_rank,
    route,
    write_lease,
)
from .journal import (  # noqa: F401
    JournalCorruptError,
    JournalRetentionError,
    RecoveredError,
    RequestJournal,
    journal_enabled,
    journal_env_dir,
    journal_fsync,
    journal_keep,
    read_journal,
)
from .rpc import (  # noqa: F401
    GateServer,
    gate_port,
    http_solve,
    serve_gate,
    serve_until_signalled,
)
from .scheduler import (  # noqa: F401
    Gate,
    GateHandle,
    LoadShedded,
    gate_classes,
    shed_classes,
    shed_depth,
)
from .tenancy import (  # noqa: F401
    OperatorRegistry,
    Tenant,
    TenantBudgetError,
    UnknownTenantError,
    mem_budget,
    operator_footprint_bytes,
)

__all__ = [
    "FleetMap",
    "FleetMember",
    "Gate",
    "GateConfig",
    "GateHandle",
    "GateServer",
    "JournalCorruptError",
    "JournalRetentionError",
    "LeaseCorruptError",
    "LoadShedded",
    "OperatorRegistry",
    "RecoveredError",
    "RequestJournal",
    "Tenant",
    "TenantBudgetError",
    "UnknownTenantError",
    "config",
    "configure",
    "fleet_lease_s",
    "fleet_replicas",
    "gate_classes",
    "gate_port",
    "http_solve",
    "journal_enabled",
    "journal_env_dir",
    "journal_fsync",
    "journal_keep",
    "mem_budget",
    "operator_footprint_bytes",
    "read_journal",
    "read_lease",
    "rendezvous_rank",
    "route",
    "serve_gate",
    "serve_until_signalled",
    "shed_classes",
    "shed_depth",
    "write_lease",
]
