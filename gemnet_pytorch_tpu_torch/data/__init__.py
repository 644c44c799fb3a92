from .graph import GraphArrays, build_graph, ragged_range, repeat_blocks  # noqa: F401
from .padding import (  # noqa: F401
    SORT_META_KEYS, PadDims, estimate_pad_dims, pad_batch, scale_graph_dims,
    strip_sort_metadata,
)
from .containers import DataContainer, Molecule  # noqa: F401
from .batch import PlanCapacity, SegmentPlan, plan_capacity, segment_plan, to_torch  # noqa: F401
from .provider import DataProvider  # noqa: F401
from .synthetic import make_dataset  # noqa: F401
