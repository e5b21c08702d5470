from repro_torch.runtime.scheduler import (  # noqa: F401
    AdmissionQueue, KVBlockPager, Request, RequestState, SlotTable,
)
from repro_torch.runtime.server import (  # noqa: F401
    AsyncBatchServer, BatchServer, decode_request, encode_request,
    encode_response,
)
from repro_torch.runtime.loadgen import (  # noqa: F401
    ServeMetrics, collect_metrics, drive_async, make_trace, run_closed_loop,
)
from repro_torch.runtime.niccost import NicCostModel, NullNicCostModel  # noqa: F401
