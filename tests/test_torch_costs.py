"""The dry run's cost counter (``repro_torch.launch.costs``) on hand-counted
programs over a fake process group, and its formulas against the JAX
package's ``launch/hloanalysis.py`` (which imports no JAX)."""
import ast
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.launch import hloanalysis as H
from repro_torch.core import collectives as CC
from repro_torch.launch import costs as C

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def groups():
    """A fake world of 16 ranks: ranks 0-7 fill one 8-GPU node, so the
    world group spans two."""
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    try:
        yield {"node": dist.new_group(list(range(8))),
               "two_nodes": dist.group.WORLD}
    finally:
        dist.destroy_process_group()


def _counted(program):
    with FakeTensorMode(), C.CostCounter() as counter:
        program(counter)
    return counter.cost


def _f32(*shape):
    return torch.empty(shape, dtype=torch.float32)


@pytest.mark.parametrize("shapes,dtype,flops,out", [
    (((16, 32), (32, 8)), torch.float32, 2 * 16 * 8 * 32, 16 * 8),
    (((4, 6), (6, 5)), torch.complex64, 4 * 2 * 4 * 5 * 6, 4 * 5),
    (((3, 4, 5), (3, 5, 6)), torch.float32, 2 * 3 * 4 * 6 * 5, 3 * 4 * 6),
    (((7, 9), (9,)), torch.float64, 2 * 7 * 9, 7),
], ids=["matmul", "complex-matmul", "bmm", "mv"])
def test_dot_flops_and_traffic(shapes, dtype, flops, out):
    """2·|result|·K (×4 complex); the traffic is the operands' reads and
    the result's write."""
    def program(counter):
        a, b = (torch.empty(s, dtype=dtype) for s in shapes)
        counter.outputs(a @ b)

    cost = _counted(program)
    size = torch.empty((), dtype=dtype).element_size()
    a, b = (torch.Size(s).numel() for s in shapes)
    assert cost.flops == flops
    assert cost.memory_bytes == (a + b + out) * size


def test_einsum_flops_decompose():
    """The sampler's contraction, ``einsum("nl,lrs->nrs")``, is counted
    through what it decomposes to."""
    def program(counter):
        counter.outputs(torch.einsum("nl,lrs->nrs", _f32(8, 4),
                                     _f32(4, 6, 3)))

    assert _counted(program).flops == 2 * 8 * 6 * 3 * 4


def test_views_move_nothing_and_in_place_writes_its_target():
    """Live bytes: arguments, outputs, temporaries and the peak of live
    storage; a view adds neither traffic nor storage."""
    def program(counter):
        x = _f32(1000)
        counter.arguments(x)
        y = x * 2                     # 4000 written
        z = y + 1                     # 4000 written: x, y, z live
        del y
        z[::2].reshape(-1)            # views
        z.add_(1)                     # 4000 written in place
        counter.outputs(z)

    cost = _counted(program)
    assert cost.memory_bytes == 3 * 4000
    assert cost.flops == 0
    assert cost.bytes_per_device() == {
        "arguments": 4000, "outputs": 4000, "temps": 4000, "aliased": 0,
        "peak_estimate": 12000}


@pytest.mark.parametrize("kind,program,result,wire", [
    ("all-reduce", lambda g: CC.psum(_f32(10), g), 40, 2 * 40 * 7 / 8),
    ("all-gather", lambda g: CC.all_gather(_f32(4, 3), g), 8 * 4 * 3 * 4,
     384 * 7 / 8),
    ("reduce-scatter", lambda g: CC.psum_scatter(_f32(2, 16, 3), g),
     2 * 2 * 3 * 4, 48 * 7),
    ("all-to-all", lambda g: _all_to_all(_f32(8, 3), g), 8 * 3 * 4,
     96 * 7 / 8),
    ("collective-permute", lambda g: CC.ppermute(_f32(5), g, [(0, 1)]),
     5 * 4, 20.0),
], ids=["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "permute"])
def test_collectives_on_a_group_of_8(groups, kind, program, result, wire):
    """The port's collectives on a fake group of 8 (one node): kind, count,
    result bytes and ring wire bytes, on NVLink."""
    def run(counter):
        counter.outputs(program(groups["node"]))

    cost = _counted(run)
    assert cost.n_collectives == {kind: 1}
    assert cost.per_collective == {kind: wire}
    assert cost.collective_wire_bytes == wire
    assert cost.wire_bytes_by_link == {"nvlink": wire, "network": 0.0}
    (c,) = cost.collectives
    assert (c.kind, c.result_bytes, c.group_size, c.link) == (
        kind, result, 8, "nvlink")
    assert cost.collective_raw_bytes == result


def _all_to_all(x, group):
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def test_a_receive_adds_no_wire(groups):
    """The other end of a permute writes its buffer and moves no wire of
    its own (the sender counts it)."""
    def run(counter):
        counter.outputs(CC.ppermute(_f32(5), groups["node"], [(1, 0)]))

    cost = _counted(run)
    assert cost.n_collectives == {} and cost.collective_wire_bytes == 0.0
    assert cost.memory_bytes == 20 + 20           # zeros_like, the receive


def test_a_group_across_nodes_moves_at_the_network_rate(groups):
    """16 ranks span two nodes: the wire goes on the network term, and the
    roofline divides it by the NIC's rate."""
    def run(counter):
        counter.outputs(CC.psum(_f32(10), groups["two_nodes"]))

    cost = _counted(run)
    wire = 2 * 40 * 15 / 16
    assert cost.wire_bytes_by_link == {"nvlink": 0.0, "network": wire}
    rf = C.roofline(cost, 16, 0.0)
    assert rf.t_collective == wire / C.NETWORK_BW
    assert rf.bottleneck == "collective"


def test_only_fake_tensors_count():
    """Real tensors under the mode are the host's (the PRNG keys)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    def program(counter):
        with unset_fake_temporarily():
            k = torch.ones(2, dtype=torch.int64) * 3
        out = _f32(4) * 2
        assert isinstance(out, FakeTensor) and not isinstance(k, FakeTensor)
        counter.outputs(out)

    cost = _counted(program)
    assert cost.memory_bytes == 16


@pytest.mark.parametrize("g", [1, 2, 4, 16])
@pytest.mark.parametrize("kind", H.COLLECTIVES)
def test_wire_bytes_are_the_references(kind, g):
    for b in (4096, 1000, 6):
        assert C._wire_bytes(kind, b, g) == H._wire_bytes(kind, b, g)


@pytest.mark.parametrize("flops,memory,wire", [
    (1e15, 1e9, 1e6), (1e9, 1e12, 1e6), (1e9, 1e9, 1e12), (0.0, 0.0, 0.0),
], ids=["compute", "memory", "collective", "empty"])
def test_roofline_picks_the_references_bottleneck(flops, memory, wire):
    """Given the reference's constants and the same terms (the wire on one
    link), the port's roofline is the reference's."""
    cost = C.Cost(flops=flops, memory_bytes=memory,
                  collective_wire_bytes=wire,
                  wire_bytes_by_link={"nvlink": 0.0, "network": wire})
    want = H.roofline(H.HLOCost(flops, memory, wire, wire, {}, {}), 256,
                      3e17).table_row()
    got = C.roofline(cost, 256, 3e17, peak_flops=H.PEAK_FLOPS,
                     hbm_bw=H.HBM_BW, network_bw=H.ICI_BW).table_row()
    assert got["bottleneck"] == want["bottleneck"]
    assert got == pytest.approx(want, rel=1e-12)


def test_constants_are_the_h100s():
    """The roofline's constants name one NVIDIA H100 80GB HBM3 at 700 W
    (data sheet), and chip_smoke.py takes its own from here."""
    assert (C.DEVICE_NAME, C.POWER_LIMIT_W) == ("NVIDIA H100 80GB HBM3", 700)
    assert (C.PEAK_FLOPS, C.HBM_BW, C.NVLINK_BW, C.NETWORK_BW) == (
        989e12, 3.35e12, 450e9, 50e9)
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    imported = {a.asname or a.name for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom)
                and node.module == "repro_torch.launch.costs"
                for a in node.names}
    assigned = {t.id for node in ast.walk(tree)
                if isinstance(node, ast.Assign) for t in node.targets
                if isinstance(t, ast.Name)}
    names = {"HBM_BYTES_PER_S", "PEAK_FP64_FLOPS", "PEAK_FP32_FLOPS",
             "PEAK_BF16_FLOPS"}
    assert names <= imported and not names & assigned
