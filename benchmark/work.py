"""The work an operation needs, whatever implements it: FLOPs and bytes.

A product of ``m x k`` by ``k x n`` is ``2 m k n`` FLOPs. A forward counts
its products once. A backward counts the products of the input gradients
(``da = dz W^T``) and, where the weights are trained, of the weight gradients
(``dW = a^T dz``), and never a recompute of the forward: an implementation that
recomputes does more than this count, so none reads above its peak. Bytes are
each input read once and each output written once, in float32, whatever an
implementation reads again.

The MPGAN message-passing layer (``x [B, N, F]``, ``K`` senders a receiver:
``N`` fully connected, ``k`` for knn): the edge MLP's first layer is two node
products (receiver and sender halves of ``W1``), its hidden layers the *edge
chain* over ``B N K`` edges, then the node MLP ``fn`` on ``[aggregate | x]``.
The knn search takes ``2 B N N C`` FLOPs of distances (``C`` features).
"""

from __future__ import annotations

import dataclasses

F32 = 4


def macs(widths) -> int:
    """Multiply-adds of one row through an MLP of these widths."""
    return sum(a * c for a, c in zip(widths[:-1], widths[1:]))


def params(widths) -> int:
    return macs(widths) + sum(widths[1:])


@dataclasses.dataclass
class Work:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def __mul__(self, k: float) -> "Work":
        return Work(self.flops * k, self.bytes * k)

    __rmul__ = __mul__


@dataclasses.dataclass(frozen=True)
class Layer:
    """One message-passing layer's shapes."""

    b: int
    n: int
    senders: int  # a receiver's: n (fully connected) or k (knn)
    f_in: int
    fe: tuple  # the edge MLP's widths after its first layer, e.g. (96, 160, 192)
    fn: tuple  # the node MLP's widths, [aggregate | x] first, e.g. (224, 256, 256, 32)
    knn: bool

    @property
    def edges(self) -> int:
        return self.b * self.n * self.senders

    @property
    def nodes(self) -> int:
        return self.b * self.n


def chain_fwd(l: Layer, search: bool = False) -> Work:
    """The edge kernel's forward: the chain over the edges and the masked sum.
    Reads ``u1``, ``u2`` (and the mask, the selection features with the knn
    search), the chain's weights; writes the aggregate (and the knn indices)."""
    h1, hl = l.fe[0], l.fe[-1]
    flops = 2 * l.edges * macs(l.fe)
    floats = 2 * l.nodes * h1 + l.nodes + params(l.fe) + l.nodes * hl
    if search:
        flops += 2 * l.b * l.n * l.n * l.f_in
        floats += 2 * l.nodes * l.f_in + l.nodes * l.senders  # features in, indices out
    return Work(flops, F32 * floats)


def chain_bwd(l: Layer, wgrads: bool) -> Work:
    """The edge kernel's backward: ``da`` through the chain (and ``dW``). Reads
    ``u1``, ``u2``, the mask (the knn indices), the aggregate's gradient and the
    weights; writes ``du1``, ``du2``, the mask's gradient and the weight
    gradients."""
    h1, hl = l.fe[0], l.fe[-1]
    flops = (2 if wgrads else 1) * 2 * l.edges * macs(l.fe)
    floats = (2 * l.nodes * h1 + l.nodes + l.nodes * hl + params(l.fe)
              + 2 * l.nodes * h1 + l.nodes + (params(l.fe) if wgrads else 0))
    if l.knn:
        floats += l.nodes * l.senders
    return Work(flops, F32 * floats)


def fn_fwd(l: Layer) -> Work:
    """The node MLP fused after the chain (the eval kernel): the chain's forward
    plus fn's products; reads ``x`` and fn's weights, writes fn's output in
    place of the aggregate."""
    chain = chain_fwd(l)
    out = l.fn[-1]
    floats = (params(l.fn) + l.nodes * l.f_in + l.nodes * out - l.nodes * l.fe[-1])
    return Work(chain.flops + 2 * l.nodes * macs(l.fn), chain.bytes + F32 * floats)


def layer_flops(l: Layer, backward: bool = False, wgrads: bool = False,
                input_grad: bool = False) -> float:
    """The whole layer's products: the first layer's two node products, the
    chain, fn; a backward's ``da`` (and ``dW``), the gradient of ``x`` itself
    only with ``input_grad``."""
    first = 2 * 2 * l.nodes * l.f_in * l.fe[0]
    chain = 2 * l.edges * macs(l.fe)
    fn = 2 * l.nodes * macs(l.fn)
    if not backward:
        search = 2 * l.b * l.n * l.n * l.f_in if l.knn else 0
        return first + chain + fn + search
    k = 2 if wgrads else 1
    return (chain + fn) * k + (first if wgrads else 0) + (first if input_grad else 0)


@dataclasses.dataclass(frozen=True)
class Model:
    """G's or D's layers, and D's last linear layer's inputs (0 for G)."""

    layers: tuple
    head: int = 0

    def flops(self, backward=False, wgrads=False, input_grad=False) -> float:
        total = 0.0
        for i, l in enumerate(self.layers):
            total += layer_flops(l, backward, wgrads, input_grad or i > 0)
        if self.head:
            b = self.layers[0].b
            total += 2 * b * self.head * (1 if not backward else (2 if wgrads else 1))
        return total


def models(args: dict, batch: int) -> tuple[Model, Model]:
    """G and D of a configuration's training arguments at ``batch``."""
    n, hid, fe, fn = args["num_hits"], args["hidden_node_size"], args["fe"], args["fn"]
    knn = not args["fully_connected"]
    senders = args["num_knn"] if knn else n
    chain = tuple(fe)

    def layer(f_in, out):
        return Layer(batch, n, senders, f_in, chain, (fe[-1] + f_in,) + tuple(fn) + (out,), knn)

    g_layers = [layer(args["latent_node_size"], hid) for _ in range(args["mp_iters_gen"] - 1)]
    g_layers.append(layer(hid, args["node_feat_size"]))
    d_layers = [layer(args["node_feat_size"], hid)]
    d_layers += [layer(hid, hid) for _ in range(args["mp_iters_disc"] - 1)]
    return Model(tuple(g_layers)), Model(tuple(d_layers), head=hid)


def train_step(args: dict) -> dict[str, Work]:
    """One D+G step's work at the configuration's batch, by operation family:
    ``model`` (every product of the step), and the edge kernels' needed work:
    ``edge_fwd`` (chain forwards in train mode), ``edge_bwd``, ``edge_fn`` (the
    fused eval forward), ``knn_fwd`` (search and chain), ``knn_bwd``."""
    g, d = models(args, args["batch_size"])
    model = (g.flops()  # G eval in the D step
             + 2 * d.flops() + 2 * d.flops(True, wgrads=True)  # D on real and fake
             + g.flops() + d.flops() + d.flops(True, input_grad=True)  # the G step
             + g.flops(True, wgrads=True))
    out = {"model": Work(model, 0.0)}
    knn = not args["fully_connected"]
    fwd, bwd = Work(), Work()
    fn = Work()
    for l in d.layers:
        fwd += 3 * chain_fwd(l, search=knn)  # D real, D fake, D in the G step
        bwd += 2 * chain_bwd(l, True) + chain_bwd(l, False)
    for l in g.layers:
        fwd += chain_fwd(l, search=knn)  # G in the G step
        bwd += chain_bwd(l, True)
        if knn:
            fwd += chain_fwd(l, search=True)  # G eval in the D step
        elif l.n <= 64:
            fn += fn_fwd(l)
        else:
            fwd += chain_fwd(l)
    if knn:
        out.update(knn_fwd=fwd, knn_bwd=bwd)
    else:
        out.update(edge_fwd=fwd, edge_bwd=bwd, edge_fn=fn)
    return out


def gen_batch(args: dict) -> dict[str, Work]:
    """One generated batch's work at the configuration's batch: ``model`` and
    the eval kernels' ``edge_fn`` (fully connected, N <= 64), ``edge_fwd``
    (fully connected, larger N) or ``knn_fwd``."""
    g, _ = models(args, args["batch_size"])
    out = {"model": Work(g.flops(), 0.0)}
    knn = not args["fully_connected"]
    fam = Work()
    for l in g.layers:
        fam += chain_fwd(l, search=True) if knn else (fn_fwd(l) if l.n <= 64 else chain_fwd(l))
    key = "knn_fwd" if knn else ("edge_fn" if g.layers[0].n <= 64 else "edge_fwd")
    out[key] = fam
    return out
