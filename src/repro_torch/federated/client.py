"""Client-side local optimization, all clients at once.

``make_local_sgd`` builds the paper's ClientUpdate: E epochs of minibatch
SGD (η=0.1, β=0.9 heavy-ball momentum, a fresh optimizer each round) on
the (U, dim_aligned) slab rows of U clients together. A ``grad_hook``
lets the baselines correct every step's gradient (FedProx's proximal
term, SCAFFOLD's control variates, Ditto's pull) without another loop.
The model's ``apply_stacked`` runs one model per client in one pass (unfolded
patches times batched products), and autograd over the sum of the
per-client mean losses gives every client its own gradient, because no
client's loss reads another client's row.

Batch order: each client and epoch uses one permutation of its n samples,
taken from an injected (U, epochs, ≥ steps·B) index tensor when one is
given (the parity tests pass the reference's permutations) or drawn from
a ``torch.Generator`` otherwise.

Memory knob: ``make_federated_local_sgd(..., chunk_size=C)`` trains the
client axis in sequential chunks of C clients, so peak activation memory
is O(C) instead of O(m), with per-client results unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import pytree
from repro_torch.data.loader import draw_permutations
from repro_torch.optim import sgd as sgdlib  # the module: optim.sgd imports core.pytree


def cross_entropy(logits, labels):
    """Mean cross-entropy over the batch; logits (B, K), labels (B,)."""
    return F.cross_entropy(logits, labels)


def stacked_loss(apply_stacked, params, x, y):
    """Sum over units of each unit's mean cross-entropy.

    params leaves (U, ...), x (U, B, ...), y (U, B). The gradient with
    respect to unit u's parameters is the gradient of unit u's own loss.
    """
    logits = apply_stacked(params, x)
    k = logits.shape[-1]
    total = F.cross_entropy(logits.reshape(-1, k), y.reshape(-1), reduction="sum")
    return total / y.shape[1]


def make_loss(apply_fn):
    """loss(params, x, y) for one model (``apply_fn`` maps one model)."""
    def loss(params, x, y):
        return cross_entropy(apply_fn(params, x), y)
    return loss


def make_local_sgd(apply_stacked, layout, *, lr=0.1, momentum=0.9, epochs=1,
                   batch_size=50, grad_hook=None):
    """Returns local_sgd(slab, x, y, perms, hook_state=None) -> trained slab.

    slab (U, dim_aligned) f32 is not modified; x (U, n, H, W, C), y (U, n);
    perms (U, epochs, >= steps·B) int64 batch orders.

    ``grad_hook(g, p, hook_state) -> g`` rewrites each step's
    (U, dim_aligned) gradient ``g`` at the rows ``p`` before the update;
    ``hook_state`` (tensors with a leading client axis, or tuples of them)
    is the same at every step.
    """

    def local_sgd(slab, x, y, perms, hook_state=None):
        units, n = y.shape
        steps = n // batch_size
        if perms.shape[0] != units or perms.shape[1] < epochs:
            raise ValueError(f"perms {tuple(perms.shape)} do not cover "
                             f"{units} clients x {epochs} epochs")
        p = slab.detach().clone().requires_grad_(True)
        buf = sgdlib.sgd_init(p, momentum=momentum)
        rows = torch.arange(units, device=slab.device)[:, None]
        for e in range(epochs):
            order = perms[:, e, : steps * batch_size]
            for s in range(steps):
                idx = order[:, s * batch_size: (s + 1) * batch_size]
                loss = stacked_loss(apply_stacked, layout.unravel(p),
                                    x[rows, idx], y[rows, idx])
                (g,) = torch.autograd.grad(loss, p)
                if grad_hook is not None:
                    g = grad_hook(g, p.detach(), hook_state)
                sgdlib.sgd_update_(p, g, buf, lr=lr, momentum=momentum)
        return p.detach()

    return local_sgd


def _rows(tree, sl):
    """Slice the leading client axis of a hook state (tensor, tuple or None)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return tuple(_rows(t, sl) for t in tree)
    return tree[sl]


def chunks(total, chunk_size):
    """Slices cutting range(total) into pieces of at most chunk_size."""
    size = total if chunk_size is None else max(1, int(chunk_size))
    return [slice(a, min(a + size, total)) for a in range(0, total, size)]


def make_federated_local_sgd(apply_stacked, layout, *, chunk_size=None,
                             mesh=None, **kw):
    """Local SGD over the client axis, in chunks of ``chunk_size`` clients.

    Returns fed(slab, x, y, hook_state=None, *, gen=None, perms=None) ->
    trained slab; ``hook_state`` (see :func:`make_local_sgd`) is cut into
    the same chunks as the slab. The
    rows are any U clients: the whole (m, dim_aligned) slab with all of
    the data, or a cohort's gathered (c, dim_aligned) rows with ``x[safe]``,
    ``y[safe]`` and their (c, epochs, ≥ steps·B) ``perms``, which the
    cohort round takes from the orders of all m clients
    (:func:`repro_torch.core.baselines.common.cohort_keys`). One of ``gen``
    (a ``torch.Generator`` on the slab's device, drawing U orders) or
    ``perms`` must be given.
    """
    if mesh is not None:
        raise NotImplementedError(
            "make_federated_local_sgd: the mesh knob is not ported yet "
            "(the mesh over torch.distributed, ROADMAP queue A)")
    local = make_local_sgd(apply_stacked, layout, **kw)
    epochs = kw.get("epochs", 1)

    def fed(slab, x, y, hook_state=None, *, gen=None, perms=None):
        m, n = y.shape
        if perms is None:
            if gen is None:
                raise ValueError("fed local SGD needs gen= or perms=")
            perms = draw_permutations(gen, m, epochs, n, device=slab.device)
        out = torch.empty_like(slab)
        for sl in chunks(m, chunk_size):
            out[sl] = local(slab[sl], x[sl], y[sl], perms[sl], _rows(hook_state, sl))
        return out

    return fed


def full_gradients(apply_stacked, layout, slab, x, y):
    """Per-client full-batch gradients: (U, dim_aligned) at the slab rows,
    each the gradient of its client's mean loss over x (U, n, ...)."""
    p = slab.detach().requires_grad_(True)  # an alias: the gradient does not write it
    (g,) = torch.autograd.grad(stacked_loss(apply_stacked, layout.unravel(p), x, y), p)
    return g


def minibatch_gradients(apply_stacked, layout, slab, xb, yb):
    """Gradients on a fixed minibatch partition: slab (U, dim_aligned),
    xb (U, K, B, ...), yb (U, K, B) -> (U, K, dim_aligned).

    Every (client, minibatch) pair is one unit of the stacked model, so
    one backward pass gives all U·K gradients."""
    units, k = yb.shape[:2]
    p = slab.repeat_interleave(k, dim=0)
    g = full_gradients(apply_stacked, layout, p, xb.reshape((units * k,) + tuple(xb.shape[2:])),
                       yb.reshape(units * k, -1))
    return g.view(units, k, -1)


@torch.no_grad()
def evaluate(apply_stacked, stacked_params, x_test, y_test, *, batch=None):
    """Per-client test accuracy, (m,) float32.

    ``batch`` bounds the client axis: accuracies are computed over
    sequential chunks of that many clients, so peak activation memory is
    O(batch · test set) instead of O(m · test set). ``None`` runs all
    clients at once (identical results).
    """
    m = y_test.shape[0]
    out = torch.empty((m,), dtype=torch.float32, device=y_test.device)
    for sl in chunks(m, batch):
        params = pytree.tree_map(lambda v: v[sl], stacked_params)
        logits = apply_stacked(params, x_test[sl])
        out[sl] = (torch.argmax(logits, dim=-1) == y_test[sl]).float().mean(dim=1)
    return out
