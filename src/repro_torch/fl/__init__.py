"""repro_torch.fl: federated round orchestration on top of the DME
estimators (port of repro/fl).

The paper positions Rand-Proj-Spatial as a subroutine for Federated
Learning; this package is the workload layer that runs it as one: a client
population model (partial participation, dropout, non-IID data,
heterogeneous budgets), a server with online correlation tracking and
temporal side-information decoding, a round driver with exact payload-byte
accounting (async staleness-1 rounds, the overlapped stream, the
chunk-ownership decode, the gspmd / shard_map backends over a
``torch.distributed`` mesh), and the paper's §5 task library. Everything runs on
the card unless the CPU is asked for by name.
"""
from .clients import Cohort, Participation, partition  # noqa: F401
from .rounds import History, RoundConfig, run_rounds  # noqa: F401
from .server import ServerState, resolve_pipeline, resolve_spec  # noqa: F401
from .tasks import TASKS, Task, get_task  # noqa: F401
