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

Parallel knob: ``make_federated_local_sgd(..., mesh=...)`` shards the
client axis across the ranks of a ``torch.distributed`` group
(:mod:`repro_torch.federated.mesh`): each rank trains its block of rows
and the trained rows are all-gathered back. ``chunk_size`` then chunks
within the rank's block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import pytree
from repro_torch.data.loader import draw_permutations
from repro_torch.federated import mesh as mesh_lib
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

    ``mesh`` (the ``FedConfig.mesh`` knob, :mod:`repro_torch.federated.mesh`)
    shards the U rows across the ranks: each rank trains its contiguous
    block (chunked within it) and the trained rows are all-gathered back.
    Every rank draws the orders of all U rows from its identically seeded
    generator and takes its block's, so the ranks train the streams the
    unsharded call trains. An axis the shard count does not divide runs
    unsharded, as the reference's ``client_vmap``; the cohort engine pads
    its slots to a shard multiple, so a cohort round always shards.
    """
    mesh = mesh_lib.resolve(mesh)
    local = make_local_sgd(apply_stacked, layout, **kw)
    epochs = kw.get("epochs", 1)

    def block(slab, x, y, perms, hook_state):
        out = torch.empty_like(slab)
        for sl in chunks(slab.shape[0], chunk_size):
            out[sl] = local(slab[sl], x[sl], y[sl], perms[sl], _rows(hook_state, sl))
        return out

    sharded = block if mesh is None else mesh_lib.shard_clients(block, mesh)

    def fed(slab, x, y, hook_state=None, *, gen=None, perms=None):
        m, n = y.shape
        if perms is None:
            if gen is None:
                raise ValueError("fed local SGD needs gen= or perms=")
            perms = draw_permutations(gen, m, epochs, n, device=slab.device)
        if mesh is not None and m % mesh.shards == 0:
            return sharded(slab, x, y, perms, hook_state)
        return block(slab, x, y, perms, hook_state)

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
def evaluate(apply_stacked, stacked_params, x_test, y_test, *, batch=None, mesh=None):
    """Per-client test accuracy, (m,) float32.

    ``batch`` bounds the client axis: accuracies are computed over
    sequential chunks of that many clients, so peak activation memory is
    O(batch · test set) instead of O(m · test set). ``None`` runs all
    clients at once (identical results).

    ``mesh`` shards the client axis: each rank evaluates its block of the
    m clients and the (m,) accuracies are all-gathered. Params of m/s rows
    are a row-sharded state's block (``FedConfig.shard_state``): the rank
    evaluates them against its block of the test set. Where the shard
    count does not divide m, the evaluation runs unsharded.
    """
    mesh = mesh_lib.resolve(mesh)
    m = y_test.shape[0]

    def acc(params, xt, yt):
        out = torch.empty((yt.shape[0],), dtype=torch.float32, device=yt.device)
        for sl in chunks(yt.shape[0], batch):
            logits = apply_stacked(pytree.tree_map(lambda v: v[sl], params), xt[sl])
            out[sl] = (torch.argmax(logits, dim=-1) == yt[sl]).float().mean(dim=1)
        return out

    rows = pytree.leaves(stacked_params)[0].shape[0]
    if mesh is None or m % mesh.shards:
        return acc(stacked_params, x_test, y_test)
    lo, hi = mesh.block(m)
    if rows == m:
        stacked_params = pytree.tree_map(lambda v: v[lo:hi], stacked_params)
    elif rows != hi - lo:
        raise ValueError(f"evaluate: {rows} param rows are neither the {m} clients nor a "
                         f"{mesh.shards}-shard block of them")
    return mesh_lib.all_gather_rows(acc(stacked_params, x_test[lo:hi], y_test[lo:hi]), mesh)
