from .jsonio import read_json, read_value_json, update_json, write_json  # noqa: F401
