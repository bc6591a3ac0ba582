"""Host data loader backed by the native reshuffle engine (port of
utils/data.py).

For a dataset too large for the card's memory, the device-side schedule
(subsampling.py) cannot hold the data.  This loader keeps the dataset in
host RAM, draws each epoch's permutation and gathers a minibatch's rows in
native threads off the GIL (``csrc/reshuffle.cc``, the port's own copy of
the reference's engine: the same splitmix64 permutations and gathers), and
``optimize_streamed`` hands each batch to the card through pinned staging
buffers with non-blocking copies; ``PrefetchingLoader`` gathers the next
batch in a host thread while the card runs the step.

The library is compiled with ``g++`` on first use into ``build/native/`` at
the root of the checkout (the file name carries a hash of the source and
flags, so an edited source is rebuilt).  If that is impossible the loader
falls back to numpy with the same contract; the two backends do not give
the same permutations, but each is deterministic per seed.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "reshuffle.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# no -march=native: the library may be built on one machine and run on another
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libreshuffle-{digest[:16]}.so"


def _load_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    out = library_path()
    try:
        if not out.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")  # concurrent builds
            subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"],
                           check=True, capture_output=True)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.avt_fill_permutation.argtypes = [
            ctypes.c_uint64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        lib.avt_gather_rows_f32.argtypes = [
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ]
        _LIB = lib
    except Exception:  # noqa: BLE001 - no g++ or no build: the numpy fallback
        _LIB_FAILED = True
    return _LIB


def native_available() -> bool:
    return _load_lib() is not None


def fill_permutation(seed: int, n: int) -> np.ndarray:
    """A permutation of range(n) (int32), deterministic in ``seed``."""
    lib = _load_lib()
    out = np.empty(n, np.int32)
    if lib is not None:
        lib.avt_fill_permutation(seed, n, out)
        return out
    return np.random.default_rng(seed).permutation(n).astype(np.int32)


def gather_rows(src: np.ndarray, idx: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """dst[k, :] = src[idx[k], :], float32, with the native threaded memcpy."""
    lib = _load_lib()
    src = np.ascontiguousarray(src, np.float32)
    idx = np.ascontiguousarray(idx, np.int32)
    dst = np.empty((idx.shape[0], src.shape[1]), np.float32)
    if lib is not None:
        if n_threads <= 0:
            n_threads = min(8, os.cpu_count() or 1)
        lib.avt_gather_rows_f32(src, idx, dst, idx.shape[0], src.shape[1], n_threads)
        return dst
    return src[idx]


class HostDataLoader:
    """Epoch-reshuffled minibatches of host-resident arrays: the schedule of
    ReshufflingBatchSubsampling (full batches only, a new permutation each
    epoch) for datasets beyond the card's memory."""

    def __init__(self, X: np.ndarray, y: Optional[np.ndarray], batchsize: int, seed: int = 0):
        self.X = np.ascontiguousarray(X, np.float32)
        self.y = (np.ascontiguousarray(np.asarray(y).reshape(len(y), -1), np.float32)
                  if y is not None else None)
        self.batchsize = batchsize
        self.n_data = self.X.shape[0]
        self.n_batches = self.n_data // batchsize
        if self.n_batches == 0:
            raise ValueError("batchsize exceeds dataset size")
        self.seed = seed
        self.epoch = 0
        self._step = 0
        self._perm = fill_permutation(seed, self.n_data)

    def __len__(self) -> int:
        return self.n_batches

    def next_batch(self) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
        """(X_batch, y_batch (B, k), indices); advances the schedule."""
        lo = self._step * self.batchsize
        idx = self._perm[lo:lo + self.batchsize]
        Xb = gather_rows(self.X, idx)
        yb = gather_rows(self.y, idx) if self.y is not None else None
        self._step += 1
        if self._step >= self.n_batches:
            self.epoch += 1
            self._step = 0
            self._perm = fill_permutation(self.seed + 0x9E3779B9 * self.epoch, self.n_data)
        return Xb, yb, idx


class PrefetchingLoader:
    """A host thread that gathers the next batches of a HostDataLoader
    (``depth`` ahead) while the card runs the step.  The thread touches numpy
    only; the copies to the card happen on the consuming thread."""

    def __init__(self, loader: HostDataLoader, depth: int = 2):
        import queue
        import threading

        self.loader = loader
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            while not self._stop.is_set():
                item = self.loader.next_batch()
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next_batch(self):
        return self._queue.get()

    def close(self) -> None:
        self._stop.set()
        try:  # drain, so that the worker leaves a full queue
            while True:
                self._queue.get_nowait()
        except Exception:  # noqa: BLE001 - queue.Empty
            pass
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _Stager:
    """numpy batches -> tensors on ``device``: on a card, through a ring of
    pinned host buffers a shape, each copied with ``non_blocking`` and
    reused only once its copy has finished (a CUDA event a slot)."""

    def __init__(self, device, slots: int = 4):
        self.device = torch.device(device)
        self.slots = slots
        self.rings: dict = {}

    def __call__(self, arr: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        if arr is None:
            return None
        if self.device.type != "cuda":
            return torch.from_numpy(arr).to(self.device)
        ring = self.rings.setdefault((arr.shape, arr.dtype.str), [[], 0])
        bufs, i = ring
        ring[1] = (i + 1) % self.slots
        if len(bufs) < self.slots:
            bufs.append((torch.from_numpy(np.empty_like(arr)).pin_memory(), None))
        buf, done = bufs[i]
        if done is not None:
            done.synchronize()
        np.copyto(buf.numpy(), arr)
        out = buf.to(self.device, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        bufs[i] = (buf, done)
        return out


def optimize_streamed(
    seed,
    algorithm,
    max_iter: int,
    prob_template,
    place_batch,
    loader,
    q_init,
):
    """Doubly-stochastic VI on minibatches streamed from host RAM:

        template = avt.factorized_target(logprior, loglike, data=(X0, y0), dim=d)
        template = dataclasses.replace(template, likeadj=torch.tensor(N / B, device=dev))
        q, infos, state = optimize_streamed(
            0, alg, 10_000, template,
            place_batch=lambda p, Xb, yb: dataclasses.replace(p, data=(Xb, yb[:, 0])),
            loader=PrefetchingLoader(HostDataLoader(X, y, batchsize=B)), q_init=q0)

    ``prob_template`` is built once at the batch's shape with likeadj = N/B
    applied; ``place_batch(prob, X_batch, y_batch) -> prob`` swaps the
    batch's tensors in (they arrive on the template's device, y as (B, k)).
    ``algorithm``: a ParamSpaceSGD whose objective does not also subsample.
    Each batch goes to the card through pinned buffers with a non-blocking
    copy, and no step waits for the device: the info rows are read once,
    after the run, and a non-finite objective raises ``DivergenceError``
    naming its first step.  Returns ``(output, infos, state)`` as
    ``optimize`` (a row a step)."""
    from ..ops.cuda.ad_body import leaf_device
    from ..optimize import DivergenceError, _read_rows

    state = algorithm.init(seed, q_init, prob_template)
    stage = _Stager(leaf_device(prob_template, default="cpu"))
    steps = []
    for _ in range(max_iter):
        Xb, yb, _ = loader.next_batch()
        state = dataclasses.replace(state, prob=place_batch(state.prob, stage(Xb), stage(yb)))
        state, info = algorithm.step(state)
        steps.append(info)
    rows = _read_rows(steps)
    for t, row in enumerate(rows):
        if row.get("diverged"):
            raise DivergenceError(f"The objective became non-finite at iteration {t + 1}.")
        row["iteration"] = t + 1
    return algorithm.output(state), rows, state
