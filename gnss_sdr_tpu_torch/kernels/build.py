"""Build and load the CUDA sources of ``csrc/`` with ``nvcc`` + ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/kernels/<name>-<hash>.so`` at the
repository root, keyed by the content hash of the source and of every
``csrc/*.cuh`` header, so an edited source or header is rebuilt and an
unchanged one is reused. :func:`build_all` starts one
``nvcc`` per source, all at once. A failed build raises with the
compiler's output. No PyTorch headers are included, which keeps a build
to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "kernels")
SOURCES = ("multicorr", "bank_corr", "acq", "conditioner", "acq_variants",
           "loops", "scan_loop", "fast_loop", "collectives")
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    cand = os.path.join(home, "bin", "nvcc") if home else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha1()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def _start(name: str):
    src, so = _target(name)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, so = job
    out, _ = proc.communicate()
    with open(so + ".log", "w") as fh:
        fh.write(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, so)


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every listed source that has no current build, one
    ``nvcc`` process per source, all started together. Returns
    ``{name: compiler log}`` of the builds that ran."""
    jobs = {name: _start(name) for name in names}
    logs = {}
    for name, job in jobs.items():
        _finish(name, job)
        if job is not None:
            with open(job[2] + ".log") as fh:
                logs[name] = fh.read()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(_target(name)[1])
            _libs[name] = lib
        return lib


_fns: dict[tuple[str, str], object] = {}


def function(lib: str, name: str, argtypes):
    """``csrc/<lib>.cu``'s launcher ``name`` with its ctypes signature
    set (returns a ``cudaError_t`` as int); cached after the first call."""
    f = _fns.get((lib, name))
    if f is None:
        f = getattr(load(lib), name)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _fns[(lib, name)] = f
    return f


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")


def check_planes(src_re, src_im, what):
    """Raise unless the sample source is two contiguous 1-D planes of one
    dtype on one device."""
    if src_re.dim() != 1 or src_re.shape != src_im.shape \
            or src_re.dtype != src_im.dtype or src_re.device != src_im.device \
            or not (src_re.is_contiguous() and src_im.is_contiguous()):
        raise ValueError(f"{what}: two contiguous 1-D planes of one dtype "
                         "and device expected")


def state_pointers(state, spec: dict, n: int, device, what: str):
    """A ctypes structure of one pointer per field of the NamedTuple
    ``state``, in field order (the layout of the kernel's C struct of the
    same fields), and the contiguous tensors it points into. ``spec``
    maps each field to its (dtype, trailing shape); every field must be
    [n, *trailing] of that dtype on ``device``, or this raises."""
    names = type(state)._fields
    if tuple(spec) != names:
        raise ValueError(f"{what}: state fields {names} are not the "
                         f"kernel's {tuple(spec)}")
    tensors = []
    for name, t in zip(names, state):
        dtype, trailing = spec[name]
        if t.dtype != dtype or tuple(t.shape) != (n, *trailing) \
                or t.device != device:
            raise ValueError(f"{what}: state field {name} must be {dtype} "
                             f"{(n, *trailing)} on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        tensors.append(t.contiguous())
    return pointer_struct(names)(*(t.data_ptr() for t in tensors)), tensors


_pointer_structs: dict[tuple[str, ...], type] = {}


def pointer_struct(names: tuple[str, ...]) -> type:
    """The ctypes structure type of one ``void*`` per name (cached)."""
    cls = _pointer_structs.get(names)
    if cls is None:
        cls = type("StatePointers", (ctypes.Structure,),
                   {"_fields_": [(n, ctypes.c_void_p) for n in names]})
        _pointer_structs[names] = cls
    return cls


def stream_ptr(device) -> int:
    """The current CUDA stream of card ``device`` (a ``torch.device`` of
    type cuda; no index: the current card) as a ``cudaStream_t`` (a Python
    int): what ``torch.cuda.current_stream(device).cuda_stream`` gives,
    read from PyTorch's C API without building a ``Stream`` object on
    every launch."""
    import torch

    idx = device.index
    if idx is None:
        idx = torch._C._cuda_getDevice()
    return torch._C._cuda_getCurrentRawStream(idx)


def launch(fn, device, *args) -> int:
    """``fn(*args, stream)``: a launcher of ``csrc/`` called on card
    ``device`` (the device of the launch's first tensor) with that card's
    current stream last; returns its ``cudaError_t``. The launchers start
    their kernels on the calling thread's current card, so a tensor on
    another card is launched under a device guard, entered only then:
    the common call, on the current card, stays a raw stream read."""
    import torch

    cur = torch._C._cuda_getDevice()
    idx = cur if device.index is None else device.index
    if idx == cur:
        return fn(*args, torch._C._cuda_getCurrentRawStream(cur))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))


def cluster_query(lib: str, name: str, device, *ints) -> dict:
    """The thread-block cluster of a launcher of ``csrc/<lib>.cu`` on card
    ``device``: its query ``name(*ints, &S, &n)`` gives the cluster size S
    (blocks a channel) the launch takes and cudaOccupancyMaxActiveClusters
    (how many such clusters the card holds at once); raises on an
    error."""
    import torch

    s, n = ctypes.c_int(), ctypes.c_int()
    f = function(lib, name, [I32] * len(ints)
                 + [ctypes.POINTER(I32), ctypes.POINTER(I32)])
    with torch.cuda.device(device):
        check(f(*(int(v) for v in ints), ctypes.byref(s), ctypes.byref(n)),
              name)
    return {"cluster_size": s.value, "max_active_clusters": n.value}


VP = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float
F64 = ctypes.c_double
U32 = ctypes.c_uint
