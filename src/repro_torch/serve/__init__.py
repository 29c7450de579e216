"""``repro_torch.serve``: the serving layer over the port's ``Retriever``,
a copy of the JAX package's ``repro.serve`` that serves from one device
(``device="cuda"`` by default): the async scheduler (micro-batching by
k-bucket x length class, the response cache, deadlines, retries, hedging,
breakers, the index hot swap), the executor pool (one CUDA stream per
slot), query-length routing, health, fault injection and the deprecated
``RetrievalServer`` shim. The sharded server waits for the port's sharded
retrieval."""
from .engine import (RetrievalServer, Request,  # noqa: F401
                     ServerConfig)
from .executor import ExecutorPool, ReplicaMap  # noqa: F401
from .faults import (Fault, FaultPlan, InjectedDeath,  # noqa: F401
                     InjectedFault, delay_route, fail_batch,
                     kill_executor, poison_generation)
from .health import (BREAKER_CLOSED, BREAKER_DEAD,  # noqa: F401
                     BREAKER_HALF_OPEN, BREAKER_OPEN, HealthConfig,
                     HealthMonitor, RetryPolicy)
from .router import (Route, RoutingPolicy, policy_summary,  # noqa: F401
                     query_length, route, single_route, table8_policy,
                     warmup_grid)
from .scheduler import (ADMISSION_POLICIES,  # noqa: F401
                        CACHE_ADMISSIONS, AsyncRetrievalScheduler,
                        DeadlineExceeded, SchedulerConfig,
                        SchedulerSaturated, SearchHandle, SearchTimeout,
                        aggregate_latencies, mixed_request_stream,
                        run_workload, truncate_terms)
