"""The nodes of the CUDA graph a stream is capturing into, read through the
CUDA driver with ctypes.

``libcuda`` is the driver PyTorch has loaded once it uses the card; this
module loads nothing else and builds nothing.  ``cuStreamGetCaptureInfo``
gives the capturing stream's graph, and ``cuGraphGetNodes`` with a null
node array gives its node count.  Both are queries: they add no node to
the graph and synchronise nothing, so they may run between the launches of
a capture.  ``repro_torch.compile`` hands :func:`count_nodes` of the
capturing stream to the capture observer (``repro_torch.obs.capture``),
which reads it at each span boundary.  :func:`node_kinds` lists each node's type and, for a
kernel node, its function handle, so two captures of the same work can be
compared node for node.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Optional, Tuple

_CAPTURE_ACTIVE = 1  # CU_STREAM_CAPTURE_STATUS_ACTIVE
_KERNEL_NODE = 0  # CU_GRAPH_NODE_TYPE_KERNEL
# room for any version of CUDA_KERNEL_NODE_PARAMS, whose first field is
# the kernel's CUfunction
_PARAMS_BYTES = 256

_P = ctypes.POINTER
_DRIVER: Optional[ctypes.CDLL] = None
_GET_INFO: Optional[Callable[[int], int]] = None
_KERNEL_PARAMS: List[Callable[..., int]] = []


def _driver() -> ctypes.CDLL:
    global _DRIVER, _GET_INFO
    if _DRIVER is not None:
        return _DRIVER
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGetErrorString.argtypes = [ctypes.c_int, _P(ctypes.c_char_p)]
    lib.cuGetErrorString.restype = ctypes.c_int
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, _P(ctypes.c_void_p),
                                    _P(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, _P(ctypes.c_int)]
    lib.cuGraphNodeGetType.restype = ctypes.c_int
    for name in ("cuGraphKernelNodeGetParams_v2",
                 "cuGraphKernelNodeGetParams"):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _KERNEL_PARAMS.append(fn)
            break
    # the graph out-parameter is the fourth in every version; v3 (CUDA
    # 12.3 on) adds the edge data before the dependency count, v2 (11.3
    # on) is kept by newer drivers for older programs
    tail = [_P(ctypes.c_void_p), _P(ctypes.c_size_t)]
    for name, extra in (("cuStreamGetCaptureInfo_v3", 1),
                        ("cuStreamGetCaptureInfo_v2", 0)):
        fn = getattr(lib, name, None)
        if fn is None:
            continue
        fn.argtypes = ([ctypes.c_void_p, _P(ctypes.c_int),
                        _P(ctypes.c_uint64), _P(ctypes.c_void_p)]
                       + [_P(ctypes.c_void_p)] * extra + tail)
        fn.restype = ctypes.c_int
        nulls = (None,) * (extra + 2)

        def get_info(stream: int, fn=fn, nulls=nulls) -> int:
            status, graph = ctypes.c_int(), ctypes.c_void_p()
            _check(lib, fn(stream, ctypes.byref(status), None,
                           ctypes.byref(graph), *nulls),
                   "cuStreamGetCaptureInfo")
            if status.value != _CAPTURE_ACTIVE or not graph.value:
                raise RuntimeError("the stream is not capturing a graph")
            return graph.value

        _GET_INFO = get_info
        break
    if _GET_INFO is None:
        raise RuntimeError("the CUDA driver has no cuStreamGetCaptureInfo_v2 "
                           "or _v3")
    _DRIVER = lib
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(err, ctypes.byref(msg))
        raise RuntimeError(f"{what}: CUDA driver error {err} "
                           f"({(msg.value or b'?').decode()})")


def _graph(stream: int) -> int:
    _driver()
    return _GET_INFO(stream)


def count_nodes(stream: int) -> int:
    """Nodes in the graph that ``stream`` (a raw ``cudaStream_t``) is
    capturing into; raises when it captures none."""
    lib = _driver()
    n = ctypes.c_size_t(0)
    _check(lib, lib.cuGraphGetNodes(_graph(stream), None, ctypes.byref(n)),
           "cuGraphGetNodes")
    return int(n.value)


def node_kinds(stream: int) -> List[Tuple[int, Optional[int]]]:
    """(node type, kernel function handle or None) of each node of the
    graph ``stream`` is capturing into, in the driver's order."""
    lib = _driver()
    graph = _graph(stream)
    n = ctypes.c_size_t(0)
    _check(lib, lib.cuGraphGetNodes(graph, None, ctypes.byref(n)),
           "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    _check(lib, lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)),
           "cuGraphGetNodes")
    out: List[Tuple[int, Optional[int]]] = []
    params = ctypes.create_string_buffer(_PARAMS_BYTES)
    for i in range(n.value):
        kind = ctypes.c_int()
        _check(lib, lib.cuGraphNodeGetType(nodes[i], ctypes.byref(kind)),
               "cuGraphNodeGetType")
        func = None
        if (kind.value == _KERNEL_NODE and _KERNEL_PARAMS
                and _KERNEL_PARAMS[0](nodes[i], params) == 0):
            func = ctypes.c_void_p.from_buffer(params).value
        out.append((kind.value, func))
    return out
