"""Async, atomic checkpointing of a flat dict of tensors (port of
``repro.checkpoint.checkpointer``, which walks a JAX pytree).

Layout:  <dir>/step_<N>/
            manifest.json          names, shapes, dtypes, offsets, meta
            shard_<i>.bin[.zst]    raw little-endian tensor bytes
         <dir>/LATEST              atomic pointer (written last)

The manifest is JSON (the reference writes msgpack, which the machine with
the card does not have); the payload is each tensor's raw bytes, so restore
is bit-exact for every dtype, bf16 included.  ``zstandard`` stays optional,
as in the reference: shards are compressed when it is installed.

Properties the preemption protocol needs (core/preemption.py):
  * async:   ``save()`` returns once every tensor is copied to host memory;
             the shards are written by a pool of threads, each starting as
             soon as its tensors are copied; ``wait()`` blocks until the
             checkpoint is complete;
  * atomic:  a checkpoint is visible only after LATEST flips; a job killed
             mid-write restores the previous checkpoint, never a torn one;
  * exact:   ``restore()`` checks the structure (names, shapes, dtypes)
             against a template and copies the bytes back unchanged;
  * bounded: only the newest ``keep`` checkpoints stay on disk.
The shards are written and read by several threads at once: file I/O
releases the interpreter lock, and a preemption's drain has to fit the
notice window.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

try:  # optional: zstd shard compression
    import zstandard
except ImportError:  # write uncompressed shards
    zstandard = None

SHARD_BYTES = 256 * 1024 * 1024
#: threads writing or reading shards at once
IO_THREADS = 8
_DTYPES = {str(t).removeprefix("torch."): t for t in (
    torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int8, torch.uint8,
    torch.int16, torch.int32, torch.int64, torch.bool)}


@dataclasses.dataclass
class CheckpointMeta:
    step: int
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _host_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU copy of ``t``'s bytes that later in-place updates of
    ``t`` do not touch."""
    t = t.detach()
    host = t.to("cpu", copy=True) if t.device.type == "cpu" else t.contiguous().cpu()
    return host.contiguous().reshape(-1).view(torch.uint8)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- public API -------------------------------------------------------------
    def save(self, step: int, tensors: Dict[str, torch.Tensor], extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        """Snapshot to host memory synchronously, write to disk async (or
        before returning, with ``blocking``)."""
        self.wait()  # one in-flight write at a time
        meta = CheckpointMeta(step=step, extra=extra or {})
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        leaves, shards = self._plan(tensors)
        pool = concurrent.futures.ThreadPoolExecutor(IO_THREADS)
        writes = []
        try:
            for shard, names in shards.items():
                parts: List[torch.Tensor] = []
                for name in names:
                    pad = leaves[name]["offset"] - sum(p.numel() for p in parts)
                    if pad:
                        parts.append(torch.zeros(pad, dtype=torch.uint8))
                    parts.append(_host_bytes(tensors[name]))
                writes.append(pool.submit(self._write_shard, os.path.join(tmp, shard), parts))
        except BaseException:
            pool.shutdown(wait=True, cancel_futures=True)
            raise

        def finish():
            try:
                for w in writes:
                    w.result()
                self._commit(step, tmp, final, leaves, list(shards), meta)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e
            finally:
                pool.shutdown(wait=True)

        if blocking:
            finish()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=finish, daemon=False)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return int(f.read().strip())

    def nbytes(self, step: Optional[int] = None) -> int:
        """Bytes on disk of one checkpoint (the latest by default)."""
        d = os.path.join(self.dir, f"step_{self.latest_step() if step is None else step}")
        return sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d))

    def restore(self, template: Dict[str, torch.Tensor], step: Optional[int] = None
                ) -> Tuple[Dict[str, torch.Tensor], CheckpointMeta]:
        """Copy the checkpoint into ``template``'s tensors, in place, and
        return them.  Raises ``ValueError`` unless the names, shapes and
        dtypes match the template exactly."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = manifest["leaves"]
        if sorted(leaves) != sorted(template):
            missing, unknown = sorted(set(template) - set(leaves)), sorted(set(leaves) - set(template))
            raise ValueError(f"checkpoint/template structure mismatch: missing {missing[:5]}, "
                             f"unexpected {unknown[:5]}")
        for name, t in template.items():
            want = leaves[name]
            if list(t.shape) != want["shape"] or _dtype_name(t) != want["dtype"]:
                raise ValueError(f"checkpoint/template mismatch at {name}: checkpoint "
                                 f"{want['dtype']} {want['shape']}, template {t.dtype} "
                                 f"{list(t.shape)}")
        by_shard: Dict[str, List[str]] = {s: [] for s in manifest["shards"]}
        for name, leaf in leaves.items():
            by_shard[leaf["shard"]].append(name)

        def load(shard: str) -> None:
            raw = self._read_shard(os.path.join(d, shard))
            with torch.no_grad():        # grad mode is per thread
                for name in by_shard[shard]:
                    leaf = leaves[name]
                    part = raw[leaf["offset"]:leaf["offset"] + leaf["nbytes"]]
                    template[name].copy_(part.view(_DTYPES[leaf["dtype"]]).reshape(leaf["shape"]))

        with concurrent.futures.ThreadPoolExecutor(IO_THREADS) as pool:
            for done in [pool.submit(load, s) for s in by_shard]:
                done.result()
        return template, CheckpointMeta(step=manifest["step"], extra=manifest["extra"])

    # -- internals ------------------------------------------------------------
    def _plan(self, tensors: Dict[str, torch.Tensor]):
        """Each tensor's shard and byte offset (8-byte aligned), shards of
        about ``SHARD_BYTES``."""
        ext = ".bin.zst" if zstandard is not None else ".bin"
        leaves: Dict[str, Dict[str, Any]] = {}
        shards: Dict[str, List[str]] = {}
        size = 0
        shard = f"shard_0{ext}"
        for name, t in tensors.items():
            if size >= SHARD_BYTES:
                shard, size = f"shard_{len(shards)}{ext}", 0
            size += -size % 8
            nbytes = t.numel() * t.element_size()
            leaves[name] = dict(shape=list(t.shape), dtype=_dtype_name(t), shard=shard,
                                offset=size, nbytes=nbytes)
            shards.setdefault(shard, []).append(name)
            size += nbytes
        return leaves, shards

    @staticmethod
    def _write_shard(path: str, parts: List[torch.Tensor]) -> None:
        with open(path, "wb") as f:
            if path.endswith(".zst"):
                f.write(zstandard.ZstdCompressor(level=1).compress(
                    b"".join(p.numpy().tobytes() for p in parts)))
            else:
                for p in parts:
                    p.numpy().tofile(f)

    @staticmethod
    def _read_shard(path: str) -> torch.Tensor:
        if path.endswith(".zst"):
            if zstandard is None:
                raise RuntimeError(f"checkpoint shard {os.path.basename(path)} is "
                                   "zstd-compressed but the 'zstandard' package is not installed")
            with open(path, "rb") as f:
                data = zstandard.ZstdDecompressor().decompress(f.read())
            return torch.frombuffer(bytearray(data), dtype=torch.uint8) if data else \
                torch.empty(0, dtype=torch.uint8)
        raw = torch.empty(os.path.getsize(path), dtype=torch.uint8)
        with open(path, "rb") as f:
            if f.readinto(memoryview(raw.numpy())) != raw.numel():
                raise OSError(f"short read of checkpoint shard {path}")
        return raw

    def _commit(self, step: int, tmp: str, final: str, leaves, shards, meta) -> None:
        manifest = {"step": step, "extra": meta.extra, "leaves": leaves, "shards": shards}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        # atomic LATEST flip
        ptr = os.path.join(self.dir, "LATEST")
        with open(ptr + ".tmp", "w") as f:
            f.write(str(step))
        os.replace(ptr + ".tmp", ptr)
        self._gc(step)

    def _gc(self, newest: int) -> None:
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(self.dir)
                       if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[: -self.keep]:
            if s != newest:
                shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err
