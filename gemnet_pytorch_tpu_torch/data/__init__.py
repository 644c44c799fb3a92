from .graph import GraphArrays, build_graph, ragged_range, repeat_blocks  # noqa: F401
from .padding import PadDims, estimate_pad_dims, pad_batch, scale_graph_dims  # noqa: F401
from .containers import DataContainer, Molecule  # noqa: F401
from .batch import (  # noqa: F401
    SORT_META_KEYS, PlanCapacity, SegmentPlan, plan_capacity, segment_plan, strip_sort_metadata,
    to_torch,
)
from .provider import DataProvider  # noqa: F401
from .synthetic import make_dataset  # noqa: F401
