"""The ctypes bindings of the CUDA kernels (`ops/_cuda.py::_FUNCTIONS`)
against the `extern "C"` entries of `csrc/*.cu`, read from the sources: the
same entries, and for each the same number of arguments, each a pointer
(`c_void_p`: a pointer or the stream) or an int (`c_int`) as the C
signature says, and the same return type. A mismatch would pass a pointer
as a 32-bit int or shift every argument after it; nothing else catches it
before the card. And `perf.trace.PROFILE_GROUPS`, which sums the device
time of each kernel group by the device functions' names, against the
`__global__` functions of the sources. Runs on the CPU (no nvcc needed).
"""

import ctypes
import re

import pytest

from gemnet_pytorch_tpu_torch.ops import _cuda
from gemnet_pytorch_tpu_torch.perf import trace

_ENTRY = re.compile(r"^([A-Za-z_][\w ]*?[\s*]+)(gemnet_\w+)\s*\(([^)]*)\)\s*\{", re.M)
_RESTYPES = {"int": ctypes.c_int, "size_t": ctypes.c_size_t, "const char*": ctypes.c_char_p}
# entries bound by hand in `_cuda._library`, not through _FUNCTIONS
_UNLISTED = {"gemnet_cuda_error_string"}


def _extern_c(source: str) -> str:
    text = (_cuda.CSRC / source).read_text()
    start = text.index('extern "C" {')
    return text[start:text.index('}  // extern "C"', start)]


def _entries() -> dict[str, tuple[str, str, list[str]]]:
    """C entry -> (source, return type, argument declarations)."""
    out = {}
    for source in _cuda.SOURCES:
        for ret, name, args in _ENTRY.findall(_extern_c(source)):
            decls = [" ".join(a.split()) for a in args.split(",") if a.strip()]
            out[name] = (source, " ".join(ret.replace("*", " * ").split()).replace(" *", "*"),
                         decls)
    return out


def _kind(decl: str):
    """c_void_p for a pointer or the stream, c_int for an int."""
    if "*" in decl or decl.startswith("cudaStream_t"):
        return ctypes.c_void_p
    assert re.fullmatch(r"int \w+", decl), f"argument {decl!r} is neither a pointer nor an int"
    return ctypes.c_int


def test_every_entry_is_bound():
    entries = _entries()
    assert set(entries) - _UNLISTED == set(_cuda._FUNCTIONS)
    assert _UNLISTED <= set(entries)


@pytest.mark.parametrize("name", sorted(_cuda._FUNCTIONS))
def test_binding_matches_c_signature(name):
    source, argtypes, restype = _cuda._FUNCTIONS[name]
    entries = _entries()
    assert name in entries, f"{name} is not an extern \"C\" entry of any source"
    c_source, c_ret, decls = entries[name]
    assert c_source == source
    assert [_kind(d) for d in decls] == list(argtypes), f"{name}: {decls}"
    assert _RESTYPES[c_ret] is restype


def _kernels() -> list[str]:
    """Every `__global__` function of the sources, by name."""
    names = set()
    for source in _cuda.SOURCES:
        text = (_cuda.CSRC / source).read_text()
        names.update(re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(",
                                text))
    return sorted(names)


def _group(name: str):
    """The group a device function belongs to: K4 (split3), K1, K2, K3, or
    None for the probe's row gathers."""
    if "split3" in name:
        return "K4"
    for prefix, group in (("outer_sum", "K1"), ("gather_contract", "K2"),
                          ("sorted_segsum", "K3")):
        if name.startswith(prefix):
            return group
    return None


def test_sources_have_the_kernels_of_every_group():
    assert {_group(k) for k in _kernels()} == {"K1", "K2", "K3", "K4", None}


@pytest.mark.parametrize("name", _kernels())
def test_profile_groups_name_every_kernel(name):
    # the profiler shows the demangled signature; the name is in it
    key = f"void (anonymous namespace)::{name}<float>(float const*, float*)"
    assert trace.profile_group(key) == _group(name)


@pytest.mark.parametrize("name", [k for k in _kernels() if _group(k) == "K4"])
def test_k4_kernels_have_one_direction(name):
    # the profiles split K4's device time into its forward and its backward
    # by these prefixes
    directions = [d for d, p in trace.K4_DIRECTIONS.items() if p in name]
    assert directions == ["forward" if name.startswith("outer_sum") else "backward"]
