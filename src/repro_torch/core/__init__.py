"""repro.core — the paper's contribution: heterogeneous mixed-mode DAG
scheduling with a Performance Trace Table, criticality / weight-based
placement and task molding (Rohlin, Fahlgren, Pericàs — HIP3ES 2019)."""
from .admission import (ALL_GATE_NAMES, AdmissionDecision, AdmissionGate,
                        AdmissionRequest, LoadSignals, NoAdmission,
                        SloAdaptiveGate, TokenBucketGate, make_gate)
from .chaos import (DEGRADE, KILL, RECOVER, ChaosEvent, ChaosPlan,
                    ChaosPlanBuilder, group_kill_plan)
from .dag import DEFAULT_IMPL, TAO, DataFootprint, ImplVariant, TaoDag, chain
from .dag_gen import (KERNEL_TYPES, bursty_workload, paper_dags, random_dag,
                      random_workload)
from .identity import trace_signature
from .locality import LocalityTracker, replay_moved_bytes
from .places import (BIG, LITTLE, ClusterSpec, fleet, hikey960, homogeneous,
                     leader_of, partition_workers, place_members,
                     valid_widths)
from .policies import (ALL_POLICY_NAMES, EXCHANGE_THRESHOLD, AdaptivePolicy,
                       CriticalityAwarePolicy, CriticalityPTTPolicy,
                       HomogeneousPolicy, MoldingPolicy, Placement, Policy,
                       WeightBasedPolicy, make_policy)
from .preemption import (ALL_PREEMPTION_NAMES, BacklogPreemption, ChunkCursor,
                         CriticalBoostPreemption, NoPreemption,
                         PreemptionController, RunningView, chunk_count,
                         make_preemption)
from .ptt import PTT, PTTRegistry
from .runtime import ChunkedWork, ThreadedRuntime
from .scheduler import SchedulerCore
from .shard import ShardedScheduler, ShardMap
from .simulator import (KernelModel, SimResult, Simulator,
                        paper_kernel_models, run_policy)
from .workload import (DagArrival, DagStats, Workload, WorkloadResult,
                       percentile)

__all__ = [
    "DEFAULT_IMPL", "DataFootprint", "ImplVariant",
    "LocalityTracker", "replay_moved_bytes",
    "TAO", "TaoDag", "chain", "KERNEL_TYPES", "paper_dags", "random_dag",
    "random_workload", "bursty_workload",
    "ALL_GATE_NAMES", "AdmissionDecision", "AdmissionGate",
    "AdmissionRequest", "LoadSignals", "NoAdmission", "SloAdaptiveGate",
    "TokenBucketGate", "make_gate",
    "BIG", "LITTLE", "ClusterSpec", "fleet", "hikey960", "homogeneous",
    "leader_of", "partition_workers", "place_members", "valid_widths",
    "EXCHANGE_THRESHOLD", "ShardMap", "ShardedScheduler",
    "ALL_POLICY_NAMES", "AdaptivePolicy", "CriticalityAwarePolicy",
    "CriticalityPTTPolicy", "HomogeneousPolicy", "MoldingPolicy",
    "Placement", "Policy", "WeightBasedPolicy", "make_policy",
    "ALL_PREEMPTION_NAMES", "BacklogPreemption", "ChunkCursor",
    "CriticalBoostPreemption", "NoPreemption", "PreemptionController",
    "RunningView", "chunk_count", "make_preemption",
    "PTT", "PTTRegistry", "ChunkedWork", "ThreadedRuntime", "SchedulerCore",
    "KernelModel", "SimResult", "Simulator", "paper_kernel_models",
    "run_policy",
    "DagArrival", "DagStats", "Workload", "WorkloadResult", "percentile",
    "trace_signature",
    "DEGRADE", "KILL", "RECOVER", "ChaosEvent", "ChaosPlan",
    "ChaosPlanBuilder", "group_kill_plan",
]
