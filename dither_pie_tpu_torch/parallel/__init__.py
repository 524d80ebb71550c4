"""Work split across devices and hosts.

* ``mesh.py``: ``make_mesh`` (a numpy array of ``torch.device`` with axis
  names; a device may repeat), the partition specs ``frames_sharding`` and
  ``replicated``, and ``device_put`` / ``Sharded`` to place a tensor's
  pieces and gather them back.
* ``sharding.py``: the sharded ordered step (K4 on each shard, the palette
  histogram summed over the mesh) and the data-parallel ED step (K1 -> K2
  -> K3 on each shard, the mean quantisation error), each shard on a CUDA
  stream of its own.
* ``auto.py``: the facade's automatic data parallelism over the local
  devices (``DITHER_PIE_TPU_AUTO_MESH``), with ``local_devices`` as its one
  seam.
* ``multihost.py``: strides a video's segment grid and a folder's file
  list over hosts that share a filesystem.

Across devices the port is one process with one controller, as the JAX
package is (``shard_map`` over the local devices; its GAN trainer is one
process too): the controller splits a batch, enqueues every shard, and
reduces in a fixed device order onto the mesh's first device. No
``torch.distributed`` process group runs: NCCL with one process a card is
outside the JAX package's design, and a process group under the tests'
parallel workers would add port collisions.
"""
