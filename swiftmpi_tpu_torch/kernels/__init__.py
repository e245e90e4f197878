"""Hand-written CUDA C++ kernels of the port, one module each.

=========  ==========================================  =================
module     replaces (Pallas kernel)                    used by
=========  ==========================================  =================
gather     ops/pallas_gather.py vmem_gather            every pull
scatter    ops/pallas_scatter.py vmem_scatter_add      the dense push
adagrad    ops/pallas_kernels.py adagrad_update        every apply
stencil    ops/pallas_stencil.py fused_stencil_gather  stencil neu1
ring       ops/pallas_ring.py ring_exchange            sharded pull/push
=========  ==========================================  =================

Each module holds the kernel's wrapper, its plain PyTorch version
(``*_plain``) and a ``launches`` counter that the wrapper bumps once per
kernel launch.  On the sharded path each launch serves all the ranks of a
card: the gather's once per pull, the scatter-add's and AdaGrad's once per
pushed family, the ring's once per exchange (one send launch and one wait
launch).  The wrapper runs the plain version for
CPU tensors and launches the kernel for CUDA tensors, with no fallback
between the two.
"""

from swiftmpi_tpu_torch.kernels import (adagrad, gather, ring, scatter,
                                        stencil)

KERNEL_MODULES = (gather, scatter, adagrad, stencil, ring)


def reset_launches() -> None:
    """Zero every kernel's launch counter."""
    for mod in KERNEL_MODULES:
        mod.launches = 0


def launch_counts() -> dict:
    return {mod.__name__.rsplit(".", 1)[-1]: mod.launches
            for mod in KERNEL_MODULES}
