"""Serving one clip over several cards: one process per card.

``mesh`` lays the ranks of a ``torch.distributed`` group out as the JAX
package's ``(data, fsdp, tensor, seq)`` mesh, ``collectives`` holds the few
collectives serving needs (each recorded for the audit), ``spmd`` the
layouts of the UNet's sites over the mesh and the tensor-parallel slicing,
``audit`` the count of one step's collectives and ``launch`` the entry that
spawns one rank per card or joins a ``torchrun`` group.
"""

from i2v_adapter_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    FSDP_AXIS,
    SEQ_AXIS,
    TENSOR_AXIS,
    Mesh,
    create_mesh,
    fsdp_spec,
    init_distributed,
)
