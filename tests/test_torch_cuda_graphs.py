"""The port's CUDA graphs against its eager path, on an NVIDIA GPU.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false. Run
them on a GPU machine with
``python -m pytest tests/test_torch_cuda_graphs.py -q --noconftest``.

- the dropout kernels read their seed from device memory: a seed tensor gives
  an int seed's outputs bit for bit, and a captured launch replayed after the
  seed tensor changed gives the new seed's;
- ``CountedGraph`` replays add the captured launches to ``launch_counts``;
- the static-buffer D+G step captured and replayed equals the eager loop bit
  for bit (parameters, optimizer state, buffers, losses, key; in float32
  and in bf16, ``--compute-dtype bfloat16``, the knn-20 and GAPT steps too),
  and the sampler's graph equals the eager sampler's jets bit for bit;
- K9's packed weights follow the parameters through graph replays: a master
  parameter changed between two replays of a captured GAPT forward (float32,
  and bf16 through ``bf16_apply``) shows in the second replay's output.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpgan_tpu_torch.data.jetnet import JetNetDataset
from mpgan_tpu_torch.models import registry
from mpgan_tpu_torch.ops import knn_kernels as kk
from mpgan_tpu_torch.ops import mp_kernels as mk
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.training import sampling
from mpgan_tpu_torch.training import train_step as ts
from mpgan_tpu_torch.training.config import from_args_dict
from mpgan_tpu_torch.training.optimizers import build_optimizer

pytestmark = pytest.mark.cuda
CARD = {"model": "mpgan", "jets": "g", "num_hits": 30}


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _dense(dev, b=64, n=30, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale  # noqa: E731
    widths = [96, 160, 192]
    hidden = []
    for a, c in zip(widths[:-1], widths[1:]):
        hidden += [r(a, c, scale=a ** -0.5), r(c, scale=0.1)]
    mask = (torch.rand(b, n, 1, generator=g, device=dev) > 0.3).float()
    return r(b, n, 96, scale=0.5), r(b, n, 96, scale=0.5), mask, tuple(hidden), r(b, n, 192)


def test_dense_kernels_read_the_seed_from_device_memory(dev):
    u1, u2, mask, hidden, g = _dense(dev)
    seed = torch.full((1,), 4321, dtype=torch.int32, device=dev)
    assert torch.equal(mk.edge_aggregate(u1, u2, mask, hidden, 0.2, True, 0.5, 4321),
                       mk.edge_aggregate(u1, u2, mask, hidden, 0.2, True, 0.5, seed))
    for need in (True, False):
        a = mk.edge_aggregate_bwd(u1, u2, mask, hidden, g, 0.2, True, 0.5, 4321, need)
        b = mk.edge_aggregate_bwd(u1, u2, mask, hidden, g, 0.2, True, 0.5, seed, need)
        assert all(torch.equal(x, y) for x, y in zip([*a[:3], *a[3]], [*b[:3], *b[3]]))


def test_knn_kernels_read_the_seed_from_device_memory(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev) * 0.5  # noqa: E731
    xs = r(16, 150, 3)
    u1, u2, mask, hidden, g = _dense(dev, 16, 150, seed=1)
    u2m = torch.cat([u2, mask], dim=-1).contiguous()
    seed = torch.full((1,), 99, dtype=torch.int32, device=dev)
    common = (xs, xs, u1, u2m, None, hidden, 20, True, False, 0.2, True, 0.5)
    a, idx, _ = kk.knn_fused_layer(*common, 99, True)
    b, idx_b, _ = kk.knn_fused_layer(*common, seed, True)
    assert torch.equal(a, b) and torch.equal(idx, idx_b)
    assert torch.equal(kk.knn_edge_aggregate(u1, u2m, idx, None, None, hidden, 0.2, True, 0.5, 99),
                       kk.knn_edge_aggregate(u1, u2m, idx, None, None, hidden, 0.2, True, 0.5,
                                             seed))
    ga = kk.knn_edge_aggregate_bwd(u1, u2m, idx, None, None, hidden, g, 0.2, True, 0.5, 99)
    gb = kk.knn_edge_aggregate_bwd(u1, u2m, idx, None, None, hidden, g, 0.2, True, 0.5, seed)
    assert all(torch.equal(x, y) for x, y in zip([*ga[:3], *ga[5]], [*gb[:3], *gb[5]]))


def test_a_replayed_launch_hashes_the_seed_in_its_buffer(dev):
    u1, u2, mask, hidden, _ = _dense(dev)
    seed = torch.full((1,), 7, dtype=torch.int32, device=dev)
    mk.reset_launch_counts()
    graph = mk.CountedGraph(lambda: mk.edge_aggregate(u1, u2, mask, hidden, 0.2, True, 0.5, seed))
    assert graph.launches == {"edge_aggregate_train": 1}
    assert mk.launch_counts["edge_aggregate_train"] == 0  # the capture ran nothing
    for value in (7, 8):
        seed.fill_(value)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(graph.out, mk.edge_aggregate(u1, u2, mask, hidden, 0.2, True, 0.5,
                                                        value))
    assert mk.launch_counts["edge_aggregate_train"] == 2 + 2


def _state(args, dev):
    suite = registry.build_suite(args)
    kg, kd = prng.split(prng.PRNGKey(0))
    g, d = suite.generator(kg, device=dev), suite.discriminator(kd, device=dev)
    return suite, ts.TrainState(g, d, build_optimizer(args.optimizer, g.parameters(), args.lr_gen),
                                build_optimizer(args.optimizer, d.parameters(), args.lr_disc),
                                prng.PRNGKey(0, dev))


KNN20 = {**CARD, "num_hits": 150, "fully_connected": False, "num_knn": 20}
GAPT = {"model": "gapt", "jets": "g", "num_hits": 30}


@pytest.mark.parametrize("card", [CARD, KNN20, {**CARD, "compute_dtype": "bfloat16"},
                                  {**KNN20, "compute_dtype": "bfloat16"},
                                  {**GAPT, "compute_dtype": "bfloat16"}],
                         ids=["flagship", "knn20", "flagship_bf16", "knn20_bf16", "gapt_bf16"])
def test_graph_steps_equal_the_eager_steps(dev, card):
    args = from_args_dict(card)
    b, steps = 32, 5
    ds = JetNetDataset("g", num_particles=args.num_hits, synthetic_num_jets=2 * b * steps)
    data = torch.as_tensor(ds.particle_data[:b * steps], device=dev)
    labels = torch.as_tensor(ds.jet_data[:b * steps], device=dev)
    cfg = ts.step_config(args)
    (suite, eager), (_, graph) = _state(args, dev), _state(args, dev)
    keys = ["Dr", "Df", "D", "G"]
    sums = {k: torch.zeros((), device=dev) for k in keys}
    graphs = ts.StepGraphs(graph, cfg, suite.noise, keys, dev, capture=True)
    order = np.arange(b * steps).reshape(steps, b)
    for idx in order:
        sel = torch.as_tensor(idx, device=dev)
        parts = ts.d_step(eager, cfg, suite.noise, data[sel], labels[sel])
        parts.update(ts.g_step(eager, cfg, suite.noise, data[sel], labels[sel]))
        for k, v in parts.items():
            sums[k] += v
    graphs.epoch(ts.step_kinds(steps), data, labels, order)
    torch.cuda.synchronize()
    assert graphs.captures == 1 and graphs.replays == steps - 2
    assert all(torch.equal(sums[k], graphs.sums[k]) for k in keys)
    for a, b_ in zip([*eager.g.state_dict().values(), *eager.d.state_dict().values()],
                     [*graph.g.state_dict().values(), *graph.d.state_dict().values()]):
        assert torch.equal(a, b_)
    for oa, ob in ((eager.g_opt, graph.g_opt), (eager.d_opt, graph.d_opt)):
        for sa, sb in zip(oa.state.values(), ob.state.values()):
            assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.equal(eager.rng, graph.rng)


def test_the_sampler_graph_equals_the_eager_sampler(dev):
    args = from_args_dict(CARD)
    suite, state = _state(args, dev)
    labels = JetNetDataset("g", num_particles=30, synthetic_num_jets=2000).jet_data[:1000]
    sampling.drop_samplers(state.g)
    mk.reset_launch_counts()
    jets = [sampling.generate_multi_batch(state.g, suite.noise,
                                          prng.PRNGKey(3, dev), 1000, 256,
                                          labels=labels, static=static) for static in (True, False)]
    np.testing.assert_array_equal(*jets)
    # 4 batches a call: the graph's replays count as the eager loop's launches
    assert mk.launch_counts["edge_aggregate_fn"] == 2 * 2 * 4


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_gapt_fused_weights_follow_the_parameters_through_replays(dev, bf16):
    """The D step's G forward (eval, no gradient: K9) captured in a graph, then a
    master parameter changed in place between two replays, as an optimizer
    step replayed in a graph changes it (no version bump): the replay equals a
    fresh eager forward on the new parameters."""
    args = from_args_dict(GAPT)
    suite, state = _state(args, dev)
    g = state.g
    noise = torch.randn(64, 30, g.cfg.embed_dim, device=dev) * 0.2
    labels = torch.rand(64, 1, device=dev) * 0.9 + 0.1

    def forward():
        with torch.no_grad():
            return ts.bf16_apply(g, noise, labels) if bf16 else g(noise, labels)

    forward()  # the packed float32 copy of the parameters is cached here
    mk.reset_launch_counts()
    graph = mk.CountedGraph(lambda: forward(), pool=mk.graph_pool())
    graph.replay()
    name = "gapt_g_fused_bf16" if bf16 else "gapt_g_fused"
    assert graph.launches == {name: 1}
    first = graph.out.clone()
    torch.testing.assert_close(first, forward(), rtol=0, atol=0)
    with torch.no_grad():
        g.final_fc.net[0].bias.add_(0.5)  # in place, as a replayed optimizer step writes it
        g.sabs[0].mab.attention.in_proj_weight.mul_(1.1)
    graph.replay()
    torch.cuda.synchronize()
    assert not torch.equal(graph.out, first)
    assert torch.equal(graph.out, forward())
