"""Compile the package's generated CUDA kernels with NVRTC and launch
them through the CUDA driver API, at first use, never at import.

Generated sources (one per program structure: kernels.rowgen for the
fused reduce, kernels.row_mask for the row mask) compile with NVRTC
into cubins, cached in the process (the MAX_KERNELS most recently used)
and on disk as `_build/gen-<hash>.cubin` (the hash is the source's and
the options'; the MAX_CUBINS most recently used), with NVRTC's log,
`ptxas -v` report included, beside each. They load and launch through
the CUDA driver API (`cuModuleLoadData`, `cuModuleGetFunction`,
`cuLaunchKernel` on torch's current stream); a module is unloaded when
no cache or plan holds its kernel any more. Every NVRTC and driver call
checks its result and raises on failure. Nothing here needs nvcc.

Every NVRTC build (a miss of both caches; a cubin read from disk is not
a compile) is reported to the observer that `observe_compiles` installs
in the calling context: the runner's, which counts it in
`recompiles_total{kind}` and `compile_ms_total`, `kind` being the
kernel's template (`fused_reduce`, `fused_reduce_multi`, `row_mask`).
"""

from __future__ import annotations

import contextvars
import ctypes
import glob
import hashlib
import os
import re
import time
import weakref
from collections import OrderedDict
from pathlib import Path

from tpu_olap_torch.obs import profile

PACKAGE = Path(__file__).resolve().parent.parent
BUILD = PACKAGE / "_build"


# ---------------------------------------------------------------------------
# NVRTC and the CUDA driver API

NVRTC_OPTIONS = ("--gpu-architecture=sm_90a", "-std=c++17",
                 "--ptxas-options=-v")
CU_FUNC_ATTRIBUTE_LOCAL_SIZE_BYTES = 3
CU_FUNC_ATTRIBUTE_NUM_REGS = 4
CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

# Bounds of the two caches of generated kernels, like the runner's plan
# cache (512 plans): a long-running engine that meets many query
# structures keeps a bounded number of modules loaded and cubins on disk.
MAX_KERNELS = 512
MAX_CUBINS = 512

_libs: dict = {}
# (source hash, shared bytes, device) -> CudaKernel, least recent first
_kernels: OrderedDict = OrderedDict()
_contexts: dict = {}     # device index -> primary context
# callable(kind, ms) told of each NVRTC build in this context
_compile_observer: contextvars.ContextVar = contextvars.ContextVar(
    "tpu_olap_torch_compile_observer", default=None)


class observe_compiles:
    """Context manager: report every NVRTC build made inside it (on this
    thread, and on threads that run a copy of its context) to
    `observer(kind, ms)`."""

    def __init__(self, observer):
        self.observer = observer

    def __enter__(self):
        self._token = _compile_observer.set(self.observer)
        return self

    def __exit__(self, *exc):
        _compile_observer.reset(self._token)
        return False


def template_kind(name: str) -> str:
    """The kernel template a generated kernel's name belongs to:
    "fused_reduce_gen" -> "fused_reduce"."""
    return name[:-len("_gen")] if name.endswith("_gen") else name


def nvrtc_library() -> ctypes.CDLL:
    """libnvrtc: the library of torch's CUDA major version by soname (as
    torch finds it), then $CUDA_HOME/lib64, then /usr/local/cuda/lib64.
    Raises when none loads."""
    lib = _libs.get("nvrtc")
    if lib is not None:
        return lib
    import torch
    major = (torch.version.cuda or "12").split(".")[0]
    cands = [f"libnvrtc.so.{major}", "libnvrtc.so"]
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            cands += sorted(glob.glob(os.path.join(home, "lib64",
                                                   "libnvrtc.so*")))
    errors = []
    for c in cands:
        try:
            lib = ctypes.CDLL(c)
            break
        except OSError as e:
            errors.append(str(e))
    else:
        raise RuntimeError("libnvrtc not found: the generated kernels need "
                           "NVRTC (" + "; ".join(errors) + ")")
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn, args in (
            ("nvrtcVersion", [P, P]),
            ("nvrtcCreateProgram", [P, ctypes.c_char_p, ctypes.c_char_p,
                                    I, P, P]),
            ("nvrtcCompileProgram", [P, I, P]),
            ("nvrtcGetProgramLogSize", [P, P]),
            ("nvrtcGetProgramLog", [P, ctypes.c_char_p]),
            ("nvrtcGetCUBINSize", [P, P]),
            ("nvrtcGetCUBIN", [P, ctypes.c_char_p]),
            ("nvrtcDestroyProgram", [P])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = I
    lib.nvrtcGetErrorString.argtypes = [I]
    lib.nvrtcGetErrorString.restype = ctypes.c_char_p
    _libs["nvrtc"] = lib
    return lib


def nvrtc_version() -> str:
    """NVRTC's version and the path it was loaded from."""
    lib = nvrtc_library()
    major, minor = ctypes.c_int(), ctypes.c_int()
    _nvrtc_check(lib, lib.nvrtcVersion(ctypes.byref(major),
                                       ctypes.byref(minor)), "nvrtcVersion")
    return f"NVRTC {major.value}.{minor.value} ({lib._name})"


def _nvrtc_check(lib, res, what):
    if res != 0:
        raise RuntimeError(f"{what} failed: NVRTC error {res} "
                           f"({lib.nvrtcGetErrorString(res).decode()})")


def driver() -> ctypes.CDLL:
    """libcuda (loaded by torch already), with the signatures used here."""
    lib = _libs.get("cuda")
    if lib is None:
        lib = ctypes.CDLL("libcuda.so.1")
        P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        for fn, args in (
                ("cuLaunchKernel", [P, U, U, U, U, U, U, U, P, P, P]),
                ("cuModuleLoadData", [P, ctypes.c_char_p]),
                ("cuModuleUnload", [P]),
                ("cuModuleGetFunction", [P, P, ctypes.c_char_p]),
                ("cuFuncSetAttribute", [P, I, I]),
                ("cuFuncGetAttribute", [P, I, P]),
                ("cuOccupancyMaxActiveBlocksPerMultiprocessor",
                 [P, P, I, ctypes.c_size_t]),
                ("cuDeviceGet", [P, I]),
                ("cuDevicePrimaryCtxRetain", [P, I]),
                ("cuCtxSetCurrent", [P]),
                ("cuGetErrorName", [I, P]),
                ("cuGetErrorString", [I, P])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = I
        _libs["cuda"] = lib
    return lib


def cu_check(res: int, what: str):
    """Raise unless a driver call returned CUDA_SUCCESS."""
    if res != 0:
        name, desc = ctypes.c_char_p(), ctypes.c_char_p()
        drv = driver()
        drv.cuGetErrorName(res, ctypes.byref(name))
        drv.cuGetErrorString(res, ctypes.byref(desc))
        raise RuntimeError(
            f"{what} failed: CUDA error {res} "
            f"({(name.value or b'?').decode()}: "
            f"{(desc.value or b'?').decode()})")


def _context(index: int) -> None:
    """Make the device's primary context (the one torch's runtime uses)
    current on this thread."""
    ctx = _contexts.get(index)
    drv = driver()
    if ctx is None:
        dev = ctypes.c_int()
        cu_check(drv.cuDeviceGet(ctypes.byref(dev), index), "cuDeviceGet")
        ctx = ctypes.c_void_p()
        cu_check(drv.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev.value),
                 "cuDevicePrimaryCtxRetain")
        _contexts[index] = ctx
    cu_check(drv.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


def source_hash(source: str) -> str:
    return hashlib.sha256((source + "\0" + " ".join(NVRTC_OPTIONS))
                          .encode()).hexdigest()[:20]


def nvrtc_compile(source: str, name: str) -> tuple:
    """(cubin bytes, NVRTC log, compile ms, from the disk cache) of a
    generated source; the cubin and log are kept in _build/ keyed by the
    hash of the source and options. Raises with the log on failure."""
    digest = source_hash(source)
    cubin_path = BUILD / f"gen-{digest}.cubin"
    log_path = cubin_path.with_suffix(".log")
    if cubin_path.exists() and log_path.exists():
        os.utime(cubin_path)  # most recently used: pruned last
        return cubin_path.read_bytes(), log_path.read_text(), 0.0, True
    lib = nvrtc_library()
    t0 = time.perf_counter()
    prog = ctypes.c_void_p()
    _nvrtc_check(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), f"{name}.cu".encode(), 0,
        None, None), "nvrtcCreateProgram")
    try:
        opts = (ctypes.c_char_p * len(NVRTC_OPTIONS))(
            *[o.encode() for o in NVRTC_OPTIONS])
        res = lib.nvrtcCompileProgram(prog, len(NVRTC_OPTIONS), opts)
        size = ctypes.c_size_t()
        lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        buf = ctypes.create_string_buffer(size.value)
        lib.nvrtcGetProgramLog(prog, buf)
        log = buf.value.decode(errors="replace")
        if res != 0:
            BUILD.mkdir(parents=True, exist_ok=True)
            (BUILD / f"gen-{digest}.failed.cu").write_text(source)
            raise RuntimeError(
                f"NVRTC failed to compile {name} (error {res}: "
                f"{lib.nvrtcGetErrorString(res).decode()}); source kept in "
                f"{BUILD}/gen-{digest}.failed.cu:\n{log}")
        _nvrtc_check(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))
    ms = (time.perf_counter() - t0) * 1000
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = cubin_path.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_bytes(cubin.raw)
    log_path.write_text(log)
    os.replace(tmp, cubin_path)
    _prune_cubins()
    return cubin.raw, log, ms, False


def _prune_cubins():
    """Keep the MAX_CUBINS most recently used cubins (and their logs)."""
    def mtime(f):
        try:
            return f.stat().st_mtime
        except FileNotFoundError:  # pruned by another process
            return 0.0
    cubins = sorted(BUILD.glob("gen-*.cubin"), key=mtime)
    for f in cubins[:max(0, len(cubins) - MAX_CUBINS)]:
        for old in (f, f.with_suffix(".log")):
            old.unlink(missing_ok=True)


def ptxas_report(log: str) -> dict:
    """Registers, spill bytes and stack frame from a `ptxas -v` report."""
    out = {}
    m = re.search(r"Used (\d+) registers", log)
    if m:
        out["registers"] = int(m.group(1))
    m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                  r"(\d+) bytes spill loads", log)
    if m:
        out["stack_bytes"] = int(m.group(1))
        out["spill_bytes"] = int(m.group(2)) + int(m.group(3))
    return out


class CudaKernel:
    """One generated kernel loaded on one device: its compile record and
    a launch through the driver API."""

    def __init__(self, source: str, name: str, threads: int,
                 smem_bytes: int, device_index: int):
        self.name, self.threads = name, threads
        self.smem_bytes, self.device_index = smem_bytes, device_index
        cubin, self.log, self.compile_ms, self.cached = nvrtc_compile(
            source, name)
        observer = _compile_observer.get()
        if observer is not None and not self.cached:
            observer(template_kind(name), self.compile_ms)
        self.report = ptxas_report(self.log)
        drv = driver()
        _context(device_index)
        self._module = ctypes.c_void_p()
        cu_check(drv.cuModuleLoadData(ctypes.byref(self._module), cubin),
                 "cuModuleLoadData")
        # unload once unreferenced; not at exit, when the context may be
        # gone already
        weakref.finalize(self, _unload, self._module.value).atexit = False
        self._func = ctypes.c_void_p()
        cu_check(drv.cuModuleGetFunction(ctypes.byref(self._func),
                                         self._module, name.encode()),
                 "cuModuleGetFunction")
        if smem_bytes > 48 * 1024:
            cu_check(drv.cuFuncSetAttribute(
                self._func, CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                smem_bytes), "cuFuncSetAttribute")
        self.registers = self._attr(CU_FUNC_ATTRIBUTE_NUM_REGS)
        self.local_bytes = self._attr(CU_FUNC_ATTRIBUTE_LOCAL_SIZE_BYTES)
        per_sm = ctypes.c_int()
        cu_check(drv.cuOccupancyMaxActiveBlocksPerMultiprocessor(
            ctypes.byref(per_sm), self._func, threads, smem_bytes),
            "cuOccupancyMaxActiveBlocksPerMultiprocessor")
        if per_sm.value < 1:
            raise RuntimeError(f"{name}: no block of {threads} threads with "
                               f"{smem_bytes} B of shared memory fits an SM")
        self.blocks_per_sm = per_sm.value
        import torch
        self.sms = torch.cuda.get_device_properties(
            device_index).multi_processor_count
        self.last_grid = 0

    def _attr(self, attr: int) -> int:
        v = ctypes.c_int()
        cu_check(driver().cuFuncGetAttribute(ctypes.byref(v), attr,
                                             self._func),
                 "cuFuncGetAttribute")
        return v.value

    @property
    def max_blocks(self) -> int:
        """Blocks resident at once: the occupancy calculator's blocks per
        SM times the SMs."""
        return self.blocks_per_sm * self.sms

    def launch(self, grid: int, params: ctypes.Structure, stream: int):
        """Launch on `stream` with one by-value struct argument; raises on
        any CUresult but success."""
        _context(self.device_index)
        if profile._capture_active:
            profile.note_launch(self.name)
        args = (ctypes.c_void_p * 1)(ctypes.addressof(params))
        cu_check(driver().cuLaunchKernel(
            self._func, grid, 1, 1, self.threads, 1, 1, self.smem_bytes,
            stream, args, None), f"cuLaunchKernel({self.name})")
        self.last_grid = grid


def _unload(module: int):
    driver().cuModuleUnload(ctypes.c_void_p(module))


def nvrtc_kernel(source: str, name: str, threads: int, smem_bytes: int,
                 device_index: int) -> CudaKernel:
    """The compiled, loaded kernel of a generated source on a device,
    cached in the process by (source hash, device): the MAX_KERNELS most
    recently used."""
    key = (source_hash(source), smem_bytes, device_index)
    k = _kernels.get(key)
    if k is None:
        k = _kernels[key] = CudaKernel(source, name, threads, smem_bytes,
                                       device_index)
        while len(_kernels) > MAX_KERNELS:
            _kernels.popitem(last=False)
    else:
        _kernels.move_to_end(key)
    return k
