"""The device mesh and the shard runtime (port of
lia_ral_tpu/parallel/mesh.py).

The framework's standard mesh axes, as in the JAX package:

* ``"data"`` — utterance/frame-batch data parallelism (every EM/TV/JFA/
  PLDA stat accumulation shards over it and sums its partials);
* ``"model"`` — optional component-axis sharding of the UBM / T-matrix /
  per-component accumulators.

A ``Mesh`` is a (n_data, n_model) grid of ``torch.device``s.  A device
may stand in the grid more than once: four shards of ``cuda:0`` run four
shards on one card, eight shards of ``cpu`` give the CPU tests the eight
shards the JAX tests get from their virtual devices.  A mesh made by
``parallel.distributed.make_global_mesh`` spans processes; each grid cell
then also names the rank that owns it.

``Mesh.run(body)`` is the port's ``shard_map``: one thread per shard of
this process calls ``body(shard)``, on a CUDA stream of its own for a CUDA
device.  ``shard.psum`` / ``shard.pmax`` are the collectives: each waits
until every shard of the process has reached the same collective, then
reduces the partials of each group (the shards that differ only along
the reduced axes) in shard-index order, with no float atomics, so every
shard of a group receives the same tensor and a rerun is equal to the
digit.  Across processes the partials are first gathered through the
process group (gloo, on the host) and reduced in the same global
shard-index order, so the result does not depend on which process holds
a shard.  Every shard must reach the same collectives in the same order
(the SPMD rule of ``shard_map``).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading

import torch

AXES = ("data", "model")


def visible_devices(kind: str = "cuda") -> list[torch.device]:
    """The devices a tool may shard over: one per card for ``cuda``, the
    one host for ``cpu``.  ``tools.common.resolve_mesh`` sizes its mesh
    by this list (tests patch it to run several shards on one device)."""
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def device_count(kind: str = "cuda") -> int:
    return len(visible_devices(kind))


def _create_handles(dev: torch.device) -> None:
    """This thread's cuBLAS and cuSOLVER handles on ``dev``: PyTorch makes
    them at a thread's first product or factorisation on a device and
    keeps them for the thread's life."""
    with torch.cuda.device(dev):
        # a factorisation first: its launches make the device's context
        # current in this thread before the cuBLAS handle is asked for
        torch.linalg.cholesky(torch.ones((1, 1), device=dev))
        torch.cuda.current_blas_handle()


def _thread_handles(devices) -> None:
    """Initializer of a mesh's shard threads: their library handles on
    every CUDA device of the mesh, before any body runs.  cuSOLVER takes a
    new handle's memory with cudaMalloc, outside PyTorch's caching
    allocator, so when the cache holds most of the card the handle fails
    (CUSOLVER_STATUS_INTERNAL_ERROR); the cached blocks are then returned
    and the handles made once more, as the allocator does before it
    reports that it is out of memory."""
    for dev in devices:
        try:
            _create_handles(dev)
        except RuntimeError:
            torch.cuda.empty_cache()
            _create_handles(dev)


class _Aborted(RuntimeError):
    """A shard left a collective because another shard failed."""


def _flatten(tree):
    """Leaves and a rebuild function of a tensor, a tuple/list of tensors
    or a dataclass of tensors (EmStats, TvAccums, SubspaceAccums)."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if dataclasses.is_dataclass(tree):
        names = [f.name for f in dataclasses.fields(tree)]
        return ([getattr(tree, n) for n in names],
                lambda leaves: type(tree)(**dict(zip(names, leaves))))
    if isinstance(tree, (tuple, list)):
        return list(tree), lambda leaves: type(tree)(leaves)
    raise TypeError(f"collective over {type(tree).__name__}")


def _event(device: torch.device):
    """An event recorded now on this thread's current stream of a CUDA
    device (None on the CPU)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _wait(device: torch.device, event, tensors=()) -> None:
    """Make this thread's current stream of ``device`` wait for ``event``
    and keep ``tensors`` alive for the work it queues after that."""
    if device.type != "cuda":
        return
    stream = torch.cuda.current_stream(device)
    if event is not None:
        stream.wait_event(event)
    for t in tensors:
        if t.device.type == "cuda" and t.device == device:
            t.record_stream(stream)


@dataclasses.dataclass
class Shard:
    """One shard inside ``Mesh.run``: its grid position, its device, and
    the collectives over the mesh axes."""

    data: int
    model: int
    device: torch.device
    _rt: "_Runtime"

    def psum(self, tree, axes="data"):
        """Sum of ``tree`` over the shards that differ from this one only
        along ``axes`` ("data", "model" or both)."""
        return self._rt.collective(self, "sum", axes, tree)

    def pmax(self, tree, axes="model"):
        """Elementwise max, as ``psum``."""
        return self._rt.collective(self, "max", axes, tree)


class _Call:
    """One collective in flight: the parts deposited so far and, once
    every local shard has deposited, the reduced result per group."""

    def __init__(self, sig):
        self.sig = sig
        self.parts: dict = {}
        self.result = None
        self.done = None
        self.read = 0


class _Runtime:
    def __init__(self, mesh: "Mesh", keys: list[tuple[int, int]]):
        self.mesh = mesh
        self.keys = keys
        self.cond = threading.Condition()
        self.calls: dict[int, _Call] = {}
        self.seq = {k: 0 for k in keys}
        self.finished = 0
        self.failed: BaseException | None = None

    def finish(self) -> None:
        """A shard's body returned: a collective that still waits for it
        can never complete."""
        with self.cond:
            self.finished += 1
            for call in self.calls.values():
                if (call.result is None and self.failed is None
                        and len(call.parts) + self.finished
                        >= len(self.keys)):
                    self.failed = RuntimeError(
                        f"a shard returned before collective {call.sig}")
            self.cond.notify_all()

    def fail(self, err: BaseException) -> None:
        with self.cond:
            if self.failed is None:
                self.failed = err
            self.cond.notify_all()

    def collective(self, shard: Shard, op: str, axes, tree):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not set(axes) <= set(AXES):
            raise ValueError(f"unknown mesh axes {axes}")
        leaves, rebuild = _flatten(tree)
        key = (shard.data, shard.model)
        ready = _event(shard.device)
        with self.cond:
            c = self.seq[key]
            self.seq[key] += 1
            call = self.calls.setdefault(c, _Call((op, axes, len(leaves))))
            if call.sig != (op, axes, len(leaves)):
                err = RuntimeError(f"shards reached different collectives: "
                                   f"{call.sig} and {(op, axes, len(leaves))}")
                self.failed = self.failed or err
                self.cond.notify_all()
                raise err
            call.parts[key] = (leaves, ready)
            if (len(call.parts) < len(self.keys) <= len(call.parts)
                    + self.finished and self.failed is None):
                self.failed = RuntimeError(
                    f"a shard returned before collective {call.sig}")
            if len(call.parts) == len(self.keys):
                try:
                    call.result, call.done = self._reduce(call, shard.device)
                except BaseException as e:      # noqa: BLE001 (re-raised)
                    self.failed = self.failed or e
                self.cond.notify_all()
            while call.result is None and self.failed is None:
                self.cond.wait()
            if self.failed is not None:
                raise _Aborted("another shard failed") from self.failed
            out = call.result[self._group(key, axes)]
            call.read += 1
            if call.read == len(self.keys):
                del self.calls[c]
        _wait(shard.device, call.done, out)
        return rebuild([t.to(shard.device) for t in out])

    @staticmethod
    def _group(key, axes) -> tuple:
        """The indices along the axes NOT reduced: shards with equal
        group indices reduce together."""
        return tuple(i for name, i in zip(AXES, key) if name not in axes)

    def _reduce(self, call: _Call, device: torch.device):
        """Every group's reduction, in shard-index order, on ``device``
        (the last arriving shard's).  Returns ({group: leaves}, the event
        that marks the results ready)."""
        op, axes, n_leaves = call.sig
        for leaves, ready in call.parts.values():
            _wait(device, ready, leaves)
        parts = {k: leaves for k, (leaves, _) in call.parts.items()}
        if self.mesh.multi_process:
            parts = self.mesh.gather_parts(parts, n_leaves)
        groups: dict = {}
        for key in sorted(parts):
            groups.setdefault(self._group(key, axes), []).append(parts[key])
        fold = torch.add if op == "sum" else torch.maximum
        result = {}
        for g, members in groups.items():
            out = []
            for i in range(n_leaves):
                acc = members[0][i].to(device)
                for m in members[1:]:
                    acc = fold(acc, m[i].to(device))
                out.append(acc)
            result[g] = out
        return result, _event(device)


class Mesh:
    """A ("data", "model") grid of devices, as ``jax.sharding.Mesh``.

    ``devices``: n_data rows of n_model devices.  ``ranks``: the owning
    process of each cell (default: all this process's); ``rank`` this
    process's; ``group`` the process group of a multi-process mesh."""

    axis_names = AXES

    def __init__(self, devices, ranks=None, rank: int = 0, group=None):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        n_data, n_model = len(self.devices), len(self.devices[0])
        if any(len(row) != n_model for row in self.devices):
            raise ValueError("mesh rows of unequal length")
        self.ranks = ([[rank] * n_model for _ in range(n_data)]
                      if ranks is None else [list(r) for r in ranks])
        self.rank = rank
        self.group = group
        self.shape = {"data": n_data, "model": n_model}
        self._streams: dict = {}
        self._pool = None

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def multi_process(self) -> bool:
        return any(r != self.rank for row in self.ranks for r in row)

    def local_keys(self) -> list[tuple[int, int]]:
        """The (data, model) cells this process runs, in shard order."""
        return [(i, j) for i in range(self.shape["data"])
                for j in range(self.shape["model"])
                if self.ranks[i][j] == self.rank]

    def device_of(self, key) -> torch.device:
        return self.devices[key[0]][key[1]]

    def _stream(self, key):
        if key not in self._streams:
            self._streams[key] = torch.cuda.Stream(self.device_of(key))
        return self._streams[key]

    def run(self, body) -> dict:
        """``body(shard)`` on every local shard, one thread each (the
        mesh's own threads, kept from run to run: a new thread pays the
        CUDA runtime's per-thread set-up again, and each makes its library
        handles when it starts, ``_thread_handles``); returns
        {(data, model): output}.  On a CUDA device each shard runs on its
        own stream, which first waits for the caller's stream; the
        caller's stream waits for every shard's before this returns.  A
        shard that raises makes the others leave their collectives, and
        the first error is raised here.  One run at a time: a body must
        not call ``run`` of its own mesh."""
        keys = self.local_keys()
        rt = _Runtime(self, keys)
        cuda_devs = {self.device_of(k) for k in keys
                     if self.device_of(k).type == "cuda"}
        start = {dev: _event(dev) for dev in cuda_devs}
        outs, ends = {}, {}

        def work(key):
            dev = self.device_of(key)
            shard = Shard(key[0], key[1], dev, rt)
            try:
                if dev.type == "cuda":
                    stream = self._stream(key)
                    with torch.cuda.device(dev), torch.cuda.stream(stream):
                        stream.wait_event(start[dev])
                        outs[key] = body(shard)
                        ends[key] = _event(dev)
                else:
                    outs[key] = body(shard)
            except BaseException as e:          # noqa: BLE001 (re-raised)
                rt.fail(e)
            else:
                rt.finish()

        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=len(keys), thread_name_prefix="mesh-shard",
                initializer=_thread_handles,
                initargs=(sorted(cuda_devs, key=str),))
        concurrent.futures.wait([self._pool.submit(work, k) for k in keys])
        if rt.failed is not None:
            raise rt.failed
        for key, ev in ends.items():
            _wait(self.device_of(key), ev, _leaves_of(outs[key]))
        return outs

    # -- assembling outputs -------------------------------------------------

    def replicated(self, outs: dict):
        """The output of a body whose result is the same on every shard
        (reduced over every axis it varies along)."""
        return outs[self.local_keys()[0]]

    def gather_parts(self, parts: dict, n_leaves: int) -> dict:
        """{key: leaves} of this process's shards → of every shard of the
        mesh, through the process group (host tensors, one all-gather a
        leaf; each rank holds the same number of shards)."""
        import torch.distributed as dist

        keys = sorted(parts)
        world = dist.get_world_size(self.group)
        owned = {r: sorted((i, j) for i in range(self.shape["data"])
                           for j in range(self.shape["model"])
                           if self.ranks[i][j] == r) for r in range(world)}
        out = {k: [None] * n_leaves for ks in owned.values() for k in ks}
        for li in range(n_leaves):
            mine = torch.stack([parts[k][li].cpu() for k in keys])
            got = [torch.empty_like(mine) for _ in range(world)]
            dist.all_gather(got, mine.contiguous(), group=self.group)
            for r, ks in owned.items():
                for p, k in enumerate(ks):
                    out[k][li] = got[r][p]
        return out

    def concat(self, outs: dict, axis: str = "data", dim: int = 0
               ) -> torch.Tensor:
        """The pieces of a sharded output joined along ``dim`` in grid
        order along ``axis`` (the first index along the other axis, where
        every shard holds the same piece).  A multi-process mesh gathers
        the pieces through the process group; the result lies on the
        first local shard's device."""
        first = self.local_keys()[0]
        dev = self.device_of(first)
        other = {"data": 1, "model": 0}[axis]
        want = sorted(k for k in (
            (i, j) for i in range(self.shape["data"])
            for j in range(self.shape["model"])) if k[other] == 0)
        if self.multi_process:
            import torch.distributed as dist

            mine = {k: outs[k].cpu() for k in outs if k[other] == 0}
            gathered = [None] * dist.get_world_size(self.group)
            dist.all_gather_object(gathered, mine, group=self.group)
            pieces = {k: v for g in gathered for k, v in g.items()}
        else:
            pieces = outs
        return torch.cat([pieces[k].to(dev) for k in want], dim=dim)


def _leaves_of(out) -> list[torch.Tensor]:
    """The tensors of a body's output (a tensor, a tuple of outputs, a
    dataclass of tensors)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if dataclasses.is_dataclass(out):
        return [t for f in dataclasses.fields(out)
                for t in _leaves_of(getattr(out, f.name))]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves_of(o)]
    return []


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices: list | None = None) -> Mesh:
    """A ("data", "model") mesh over ``devices`` (default: the visible
    cards), the first n_data·n_model of them in row-major order."""
    devs = list(devices) if devices is not None else visible_devices("cuda")
    if n_data is None:
        n_data = len(devs) // n_model
    if not 0 < n_data * n_model <= len(devs):
        raise ValueError(f"mesh {n_data}x{n_model} needs more than "
                         f"{len(devs)} devices")
    return Mesh([devs[i * n_model:(i + 1) * n_model]
                 for i in range(n_data)])
