"""A bf16 layer over k particles' row blocks as the port ran it before
the blocks' GEMMs ran side by side: each block's ``F.linear`` joined by
``torch.cat``, each block's weight GEMM joined by ``torch.stack`` and
summed in float32.  The reference that ``models.modules._ParticleDense``
is held to, bit for bit, on the CPU (``tests/test_torch_particle_dense.py``)
and on the card (``tests/test_torch_particles_cuda.py``).  Imports no JAX.
"""

import torch
import torch.nn.functional as F


class JoinedBlocks(torch.autograd.Function):
    """``_ParticleDense``'s arithmetic, the blocks run in turn and joined."""

    @staticmethod
    def forward(ctx, x, weight, bias, particles):
        w, b = weight.to(x.dtype), bias.to(x.dtype)
        ctx.save_for_backward(x, w)
        ctx.particles = particles
        return torch.cat([F.linear(rows, w, b)
                          for rows in x.chunk(particles)])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        k = ctx.particles
        per_block = torch.stack([g.t().mm(r) for g, r in zip(grad.chunk(k),
                                                             x.chunk(k))])
        return (grad.matmul(w),
                torch.sum(per_block, dim=0, dtype=torch.float32),
                torch.sum(torch.sum(grad.reshape(k, -1, grad.shape[-1]),
                                    dim=1), dim=0, dtype=torch.float32),
                None)


def output_and_grads(function, x, weight, bias, grad, k):
    """``function.apply(x, weight, bias, k)`` (detached) and its gradients
    of ``x``, ``weight`` and ``bias`` under the output gradient ``grad``."""
    out = function.apply(x, weight, bias, k)
    return (out.detach(), *torch.autograd.grad(out, (x, weight, bias), grad))
