from .gemnet import GemNet, energy_and_forces, finalize_outputs  # noqa: F401
from .scaling import load_scales_from_json, scale_names_in_creation_order  # noqa: F401
