"""Device mesh + sharding helpers (SPMD data parallelism).

The reference's only parallelism is ``tf.distribute.MirroredStrategy`` data
parallelism with NCCL all-reduce (SURVEY.md §2); the equivalent here is a
1-D ``jax.sharding.Mesh`` over all devices with batch-sharded data and
replicated params — XLA inserts the gradient ``psum`` at compile time and
hands it to NCCL on GPUs. Models here are <100M params, so DP is the whole
story; the helpers keep an explicit mesh so multi-host runs extend
naturally. Meshes are built from ``jax.devices()`` alone: every GPU of a
host reaches every other over NVLink at the same rate, so the layout
follows the algorithm, not a torus.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
SOURCE_AXIS = "source"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None,
              axis_name: str = DATA_AXIS) -> Mesh:
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis_name,))


def make_source_mesh(n_sources: int = 2,
                     devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """2-D mesh ``(source, data)`` for source-sharded BASIS separation.

    Pure frame sharding shrinks the per-apply conv batch as devices are
    added. Sharding the SOURCE axis too keeps every device at one model x
    twice the frames, at the cost of one small per-step all-reduce for the
    mixing softmax (the iterate is ~KBs).
    """
    devices = list(devices) if devices is not None else jax.devices()
    n = len(devices)
    if n % n_sources:
        raise ValueError(f"{n} devices not divisible by {n_sources} sources")
    arr = np.array(devices).reshape(n_sources, n // n_sources)
    return Mesh(arr, (SOURCE_AXIS, DATA_AXIS))


def source_sharding(mesh: Mesh) -> NamedSharding:
    """x [K, N, ...]: source axis over SOURCE_AXIS, frames over DATA_AXIS."""
    return NamedSharding(mesh, P(SOURCE_AXIS, DATA_AXIS))


def params_by_source(params: Any, mesh: Mesh) -> Any:
    """Stacked per-source params [K, ...]: each chip row holds ONE model."""
    s = NamedSharding(mesh, P(SOURCE_AXIS))
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, s), params)


def batch_sharding(mesh: Mesh, batch_axis: int = 0) -> NamedSharding:
    """Shard the given axis over the mesh, replicate the rest."""
    spec = [None] * (batch_axis + 1)
    spec[batch_axis] = DATA_AXIS
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(x: Any, mesh: Mesh, batch_axis: int = 0) -> Any:
    """Device-put a pytree of batch arrays with the batch axis sharded."""
    s = batch_sharding(mesh, batch_axis)
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, s), x)


def replicate(params: Any, mesh: Mesh) -> Any:
    s = replicated(mesh)
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, s), params)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def put_global_batch(batch: Any, mesh: Optional[Mesh],
                     batch_axis: int = 0) -> Any:
    """Device-put one batch with the batch axis sharded over ``mesh``.

    Single-process: a plain sharded ``device_put``. Multi-process (one
    process per host / the 2-process CPU test cluster): ``batch`` is this
    host's local shard of the global batch (the loaders shard per host via
    ``num_hosts``/``host_id``), assembled into one global array with
    ``host_local_array_to_global_array`` — the analog of the reference's
    ``strategy.experimental_distribute_dataset`` (data_loader.py:104-107),
    except sharding happens at transfer time instead of graph rewrite time.
    """
    import jax.numpy as jnp

    if mesh is None:
        return jnp.asarray(batch)
    if jax.process_count() == 1:
        arr = jnp.asarray(batch)
        # a partial final eval batch (drop_remainder=False) need not divide
        # the mesh: device_put with a batch-sharded NamedSharding raises on
        # indivisible axes, so fall back to a replicated put — correctness
        # over speed for the one remainder batch per epoch
        if arr.shape[batch_axis] % mesh.devices.size != 0:
            return jax.device_put(arr, replicated(mesh))
        return jax.device_put(arr, batch_sharding(mesh, batch_axis))
    from jax.experimental import multihost_utils

    spec = [None] * (batch_axis + 1)
    spec[batch_axis] = mesh.axis_names[0]
    return multihost_utils.host_local_array_to_global_array(
        np.asarray(batch), mesh, P(*spec))


def make_mesh_for_batch(batch_size: int,
                        axis_name: str = DATA_AXIS) -> Optional[Mesh]:
    """Data mesh over the largest device count that divides ``batch_size``.

    Returns ``None`` when only one device would be used (callers then skip
    sharding entirely).
    """
    n = jax.device_count()
    while n > 1 and batch_size % n != 0:
        n -= 1
    if n <= 1:
        return None
    return make_mesh(jax.devices()[:n], axis_name)


def init_distributed(coordinator_address: Optional[str],
                     num_processes: Optional[int],
                     process_id: Optional[int]) -> None:
    """Initialise multi-process JAX (one process per host).

    Thin wrapper over ``jax.distributed.initialize``. Nothing in a plain
    GPU cluster tells JAX where its coordinator is, so the coordinator
    address (``host:port``), the process count and this process's index
    are passed explicitly. Call before any other JAX API in each process.
    (The reference is single-host only — SURVEY.md §2 "Multi-host /
    elastic: Absent"; this extends it.)
    """
    if not coordinator_address or num_processes is None \
            or process_id is None:
        raise ValueError(
            "multi-process JAX needs --coordinator_address host:port, "
            "--num_processes and --process_id")
    import jax.distributed
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
