"""The train window's guard and update on the CPU: the multi-tensor launch
plan of ops/csrc/guarded_adam.cu (its chunk table), the host entries
against the CUDA source's, and the dispatch of trainer.guarded_adam_.  The
kernels themselves run on the card (tests/test_torch_cuda.py -k adam)."""
import re
from pathlib import Path

import pytest
import torch

from dss_tpu_torch.models.point_model import PointModelParams
from dss_tpu_torch.ops import kernels
from dss_tpu_torch.training import trainer

C = kernels.MT_CHUNK
SOURCE = (Path(kernels.__file__).parent / "csrc" / "guarded_adam.cu").read_text()


def _covered(sizes, launches, max_tensors):
    """Raise unless the launches cover every element of every tensor
    exactly once, in the kernel's mapping: block b of a launch works on the
    last tensor whose first block is ≤ b, on its chunk b − first."""
    seen = [torch.zeros(n, dtype=torch.int64) for n in sizes]
    order = []
    for launch in launches:
        assert 0 < len(launch) <= max_tensors
        firsts = [first for _, first, _ in launch]
        assert firsts[0] == 0
        for (_, first, nb), nxt in zip(launch, firsts[1:] + [None]):
            assert nb >= 1 and (nxt is None or nxt == first + nb)
        n_blocks = launch[-1][1] + launch[-1][2]
        for b in range(n_blocks):
            i, first, _ = [e for e in launch if e[1] <= b][-1]
            lo = (b - first) * C
            seen[i][lo:min(lo + C, sizes[i])] += 1
        order += [i for i, _, _ in launch]
    assert order == list(range(len(sizes)))
    for i, s in enumerate(seen):
        assert torch.equal(s, torch.ones_like(s)), i


@pytest.mark.parametrize("sizes", [[1], [C - 1], [C], [C + 1], [0],
                                   [1, C - 1, C, C + 1, 0, 3 * C + 7]],
                         ids=["1", "chunk-1", "chunk", "chunk+1", "0", "mixed"])
@pytest.mark.parametrize("max_tensors", [kernels.ADAM_MAX_TENSORS,
                                         kernels.FINITE_MAX_TENSORS],
                         ids=["update", "guard"])
def test_chunk_table_covers_every_element_once(sizes, max_tensors):
    launches = kernels.chunk_launches(sizes, max_tensors)
    assert len(launches) == 1
    _covered(sizes, launches, max_tensors)
    assert [nb for _, _, nb in launches[0]] == [max(1, -(-n // C))
                                                for n in sizes]


@pytest.mark.parametrize("max_tensors", [kernels.ADAM_MAX_TENSORS,
                                         kernels.FINITE_MAX_TENSORS],
                         ids=["update", "guard"])
def test_chunk_table_splits_a_long_list_into_launches(max_tensors):
    sizes = [(i * 997) % (2 * C + 3) for i in range(2 * max_tensors + 5)]
    launches = kernels.chunk_launches(sizes, max_tensors)
    assert [len(x) for x in launches] == [max_tensors, max_tensors, 5]
    _covered(sizes, launches, max_tensors)


def _source_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def _source_fields(struct):
    body = re.search(rf"struct {struct} {{(.*?)}};", SOURCE, re.S).group(1)
    names = []
    for decl in body.split(";")[:-1]:
        decl = re.sub(r"\[.*?\]", "", decl.split("//")[0]).strip()
        names += [re.split(r"[\s*]+", part.strip())[-1]
                  for part in decl.split(",")]
    return names


def test_host_entries_and_limits_match_the_cuda_source():
    """The ctypes entries name the C structs' fields in their order, and
    the wrapper's limits are the kernel's constants."""
    assert [f for f, _ in kernels._AdamEntry._fields_] == _source_fields(
        "AdamEntry")
    assert [f for f, _ in kernels._FiniteEntry._fields_] == _source_fields(
        "FiniteEntry")
    for name, value in (("CHUNK", kernels.MT_CHUNK),
                        ("MAX_TENSORS", kernels.ADAM_MAX_TENSORS),
                        ("MAX_FINITE", kernels.FINITE_MAX_TENSORS),
                        ("MAX_MILESTONES", kernels.ADAM_MAX_MILESTONES)):
        assert _source_int(name) == value, name


def test_all_finite_on_the_cpu():
    xs = [torch.ones(5), torch.zeros(2, 3), torch.ones(())]
    assert kernels.all_finite(xs).ndim == 0 and bool(kernels.all_finite(xs))
    for bad in (float("nan"), float("inf"), -float("inf")):
        ys = [x.clone() for x in xs]
        ys[1][1, 2] = bad
        assert not bool(kernels.all_finite(ys))


def _optimizer(seed):
    gen = torch.Generator().manual_seed(seed)
    pts = torch.randn((40, 3), generator=gen)
    params = PointModelParams.create(pts, pts, torch.rand((40, 3),
                                                          generator=gen),
                                     device="cpu")
    opt = trainer.make_optimizer(params, milestones=(1, 3), gamma=0.5)
    grads = [torch.randn(t.shape, generator=gen) for t in params.tensors()]
    return params, opt, grads


def test_guarded_adam_takes_the_composite_on_the_cpu():
    """CPU tensors take guarded_adam_plain: the same bits, the counts and
    the lr milestones included; the kernel's wrapper refuses them."""
    runs = []
    for fn in (trainer.guarded_adam_, trainer.guarded_adam_plain):
        params, opt, grads = _optimizer(0)
        for _ in range(4):
            fn(opt, grads, kernels.all_finite(grads))
        runs.append([t.detach().clone() for t in params.tensors()]
                    + [opt.state[t][k].clone() for t in params.tensors()
                       for k in ("exp_avg", "exp_avg_sq", "step")])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert float(runs[0][5]) == 4.0
    params, opt, grads = _optimizer(0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.guarded_adam(list(params.tensors()), grads, grads, grads,
                             [torch.zeros(())] * 3,
                             [kernels.AdamHyper(0.9, 0.999, 1e-8, 0.1, 0.5)] * 3,
                             torch.ones((), dtype=torch.bool),
                             torch.zeros(kernels.ADAM_MAX_TENSORS,
                                         dtype=torch.int32))
