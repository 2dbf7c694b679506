"""The port's analysis modules against the JAX package's: CSD encoding and
shift-add synthesis (``core/csd.py``), ``quant.pruned_fraction``, the ASIC
cost model (``core/costmodel.py``, Tables I, II, IV, V, Fig. 3) and the FPGA
model (``core/fpga.py``, Tables VI, VII).

Every output is held EQUAL to the JAX package's, with no tolerance: the CSD
functions over every int4 and int8 value, ``shift_add_eval`` over every
int8 activation, and each cost and FPGA function without codes, with the
JAX package's LAQ codes and with the port's LAQ codes of the same seeded
weights (which are equal first).  The paper's own numbers, as
``tests/test_costmodel.py`` and ``tests/test_csd.py`` assert them for the
JAX package, are asserted for the port as the cases of one test."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

import jax.numpy as jnp

from repro.core import costmodel as jcost
from repro.core import csd as jcsd
from repro.core import fpga as jfpga
from repro.core import quant as jquant
from repro_torch.core import costmodel, csd, fpga, quant, splitbrain

RANGES = {4: range(-8, 8), 8: range(-128, 128)}
INT8_ACTS = np.arange(-128, 128, dtype=np.int32)


@pytest.mark.parametrize("bits", [4, 8])
def test_csd_digits_plans_and_tables_equal_the_reference(bits):
    assert csd.__all__ == jcsd.__all__
    for v in RANGES[bits]:
        assert csd.csd_encode(v) == jcsd.csd_encode(v)
        assert csd.csd_nonzero_digits(v) == jcsd.csd_nonzero_digits(v)
        assert csd.binary_nonzero_digits(v) == jcsd.binary_nonzero_digits(v)
        ours, ref = csd.shift_add_plan(v), jcsd.shift_add_plan(v)
        assert dataclasses.astuple(ours) == dataclasses.astuple(ref)
        assert (ours.num_terms, ours.num_adders) == (ref.num_terms,
                                                     ref.num_adders)
    for table in ("csd_cost_table", "binary_cost_table"):
        ours, ref = getattr(csd, table)(bits), getattr(jcsd, table)(bits)
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("bits", [4, 8])
def test_shift_add_eval_is_exact_over_every_int8_activation(bits):
    """Every weight's plan on every int8 activation: the port's int32
    tensor equals the JAX package's array and ``w * x``."""
    x = torch.from_numpy(INT8_ACTS.astype(np.int8))
    for w in RANGES[bits]:
        ours = csd.shift_add_eval(csd.shift_add_plan(w), x)
        ref = np.asarray(jcsd.shift_add_eval(jcsd.shift_add_plan(w),
                                             jnp.asarray(INT8_ACTS)))
        assert ours.dtype == torch.int32 and ours.device == x.device
        np.testing.assert_array_equal(ours.numpy(), ref)
        np.testing.assert_array_equal(ours.numpy(), w * INT8_ACTS)


@pytest.mark.parametrize("bits,lo", [(8, -127), (4, -7)])
def test_adder_reduction_equals_the_reference(bits, lo):
    """The seeded 100,000-value population of the paper-tables harness
    (``benchmarks/tables.py``), and its int4 counterpart."""
    vals = np.random.default_rng(0).integers(lo, -lo + 1, 100_000)
    assert csd.adder_reduction(vals, bits) == jcsd.adder_reduction(vals, bits)


def _weights(shape, seed, scale):
    return (np.random.default_rng(seed).normal(size=shape)
            .astype(np.float32) * scale)


@pytest.mark.parametrize("shape,seed,scale", [((256, 128), 0, 0.1),
                                              ((1024, 512), 1, 0.05)])
def test_pruned_fraction_equals_the_reference(shape, seed, scale):
    """The cost model's weights below and the paper-tables harness's
    (``benchmarks/tables.py``: (1024, 512) x 0.05, seed 1)."""
    w = _weights(shape, seed, scale)
    ref = jquant.quantize_weights(jnp.asarray(w))
    ours = quant.quantize_weights(torch.from_numpy(w))
    np.testing.assert_array_equal(ours.codes.numpy(), np.asarray(ref.codes))
    got = quant.pruned_fraction(ours)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert got.item() == float(jquant.pruned_fraction(ref))


def test_pruned_fraction_rounds_as_the_reference_at_any_size():
    """Seeded code populations of 12 sizes that are not powers of two
    (where the share times the reciprocal of the size and the quotient
    part on some sizes), zero shares from none to all."""
    rng = np.random.default_rng(5)
    for n in rng.integers(1, 200_000, 12):
        c = rng.integers(-7, 8, int(n)).astype(np.int8)
        c[rng.random(int(n)) < rng.random()] = 0
        ref = jquant.QuantizedLinear(codes=jnp.asarray(c),
                                     scales=jnp.ones((1,), jnp.float32))
        ours = quant.QuantizedLinear(codes=torch.from_numpy(c),
                                     scales=torch.ones(1))
        assert quant.pruned_fraction(ours).item() == \
            float(jquant.pruned_fraction(ref)), n


@pytest.fixture(scope="module")
def codes():
    """LAQ codes of the same seeded (256, 128) weights from both packages:
    ``None`` (the paper's reference point), the JAX package's as numpy, the
    port's as a tensor."""
    w = _weights((256, 128), 0, 0.1)
    ref = np.asarray(jquant.quantize_weights(jnp.asarray(w)).codes)
    ours = quant.quantize_weights(torch.from_numpy(w)).codes
    np.testing.assert_array_equal(ours.numpy(), ref)
    return {"none": None, "jax_codes": ref, "port_codes": ours}


# (name, call on a module, takes codes): every public function of both
# models; the ones without codes run once per case all the same
MODEL_CALLS = [
    ("gate_reduction", lambda m, c: m.gate_reduction(c)),
    ("ita_mac_gates", lambda m, c: dataclasses.asdict(m.ita_mac_gates(c))),
    ("ita_mac_gates_act4",
     lambda m, c: dataclasses.asdict(m.ita_mac_gates(c, act_bits=4))),
    ("ita_mac_energy", lambda m, c: m.ita_mac_energy(c)),
    ("energy_comparison", lambda m, c: m.energy_comparison(c)),
    ("gpu_mac_energy", lambda m, c: [m.gpu_mac_energy(p)
                                     for p in ("fp16", "int8")]),
    ("system_power", lambda m, c: [m.system_power(),
                                   m.system_power(37.5, 1.1e9)]),
    ("die_area_mm2", lambda m, c: [
        m.die_area_mm2(p, b, conservative=cons, optimized=opt)
        for p in (1.1e9, 7e9, 42e9) for b in (4, 8)
        for cons in (False, True) for opt in (False, True)]),
    ("dies_per_wafer", lambda m, c: [m.dies_per_wafer(a)
                                     for a in (50.0, 414.3, 520.0, 900.0)]),
    ("unit_cost", lambda m, c: [
        m.unit_cost(p, conservative=cons, volume=v)
        for p in (1.1e9, 7e9, 70e9) for cons in (False, True)
        for v in (10_000, 1_000_000)]),
    ("attack_vectors", lambda m, c: m.ATTACK_VECTORS),
    ("extraction_barrier", lambda m, c: m.extraction_barrier()),
]
FPGA_CALLS = [
    ("hardwired_mac_resources", lambda m, c: m.hardwired_mac_resources(c)),
    ("single_neuron_table", lambda m, c: [m.single_neuron_table(c),
                                          m.single_neuron_table(c, 128)]),
    ("full_network_table", lambda m, c: [m.full_network_table(),
                                         m.full_network_table((32, 64))]),
    ("fpga_vs_asic_gap", lambda m, c: m.fpga_vs_asic_gap(c)),
]


@pytest.mark.parametrize("case", ["none", "jax_codes", "port_codes"])
@pytest.mark.parametrize(
    "module,name,call",
    [("costmodel",) + c for c in MODEL_CALLS]
    + [("fpga",) + c for c in FPGA_CALLS],
    ids=[f"costmodel.{c[0]}" for c in MODEL_CALLS]
    + [f"fpga.{c[0]}" for c in FPGA_CALLS])
def test_model_outputs_equal_the_reference(codes, case, module, name, call):
    ours_mod, ref_mod = {"costmodel": (costmodel, jcost),
                         "fpga": (fpga, jfpga)}[module]
    c = codes[case]
    ref_codes = None if c is None else np.asarray(codes["jax_codes"])
    ours = call(ours_mod, c)
    assert ours == call(ref_mod, ref_codes)
    # the dicts hold Python numbers as the reference's do, not arrays
    assert repr(ours) == repr(call(ref_mod, ref_codes))


def test_constants_equal_the_reference():
    for mod, ref in ((costmodel, jcost), (fpga, jfpga)):
        names = {k for k, v in vars(ref).items()
                 if k.isupper() and isinstance(v, (int, float, dict))}
        assert names and all(getattr(mod, k) == getattr(ref, k)
                             for k in names)


def test_codes_on_any_device_are_read_once_as_numpy(codes):
    """A tensor's codes go through the same numpy path as the reference's
    array: a non-contiguous int8 view and an int64 copy give its dicts."""
    t = codes["port_codes"]
    view = t.t()
    want = jcost.gate_reduction(np.asarray(codes["jax_codes"]).T)
    assert costmodel.gate_reduction(view) == want
    assert costmodel.gate_reduction(t.to(torch.int64)) == \
        jcost.gate_reduction(codes["jax_codes"])
    np.testing.assert_array_equal(costmodel.as_codes(view),
                                  codes["jax_codes"].T)


def _real_gate_reduction():
    w = _weights((256, 128), 0, 0.1)
    return costmodel.gate_reduction(
        quant.quantize_weights(torch.from_numpy(w)).codes)["reduction_x"]


def _naf(n):
    """``n``'s CSD digits add up to ``n`` and no two are adjacent."""
    digits = csd.csd_encode(n)
    shifts = sorted(sh for _, sh in digits)
    return (sum(s * 2 ** sh for s, sh in digits) == n
            and all(b - a >= 2 for a, b in zip(shifts, shifts[1:])))


# the paper's numbers, as tests/test_costmodel.py and tests/test_csd.py
# assert them for the JAX package: (id, value, check)
PAPER = [
    ("table1.generic_gates", lambda: costmodel.gate_reduction()
     ["generic_int8_gates"], lambda v: v == 1180),
    ("table1.ita_gates", lambda: costmodel.gate_reduction()["ita_gates"],
     lambda v: v == pytest.approx(243, abs=1)),
    ("table1.shift_add_tree", lambda: costmodel.gate_reduction()
     ["ita_shift_add_tree"], lambda v: v == pytest.approx(156, abs=1)),
    ("table1.accumulator", lambda: costmodel.gate_reduction()
     ["ita_accumulator"], lambda v: v == pytest.approx(68, abs=1)),
    ("table1.pipeline_register", lambda: costmodel.gate_reduction()
     ["ita_pipeline_register"], lambda v: v == pytest.approx(19, abs=1)),
    ("table1.reduction_x", lambda: costmodel.gate_reduction()["reduction_x"],
     lambda v: v == pytest.approx(4.85, abs=0.05)),
    ("table1.real_laq_weights", _real_gate_reduction, lambda v: v > 4.85),
    ("table2.gpu_fp16", lambda: costmodel.energy_comparison()["gpu_fp16"]
     ["total_pj"], lambda v: v == pytest.approx(401.1, abs=0.5)),
    ("table2.gpu_int8", lambda: costmodel.energy_comparison()["gpu_int8"]
     ["total_pj"], lambda v: v == pytest.approx(201.0, abs=0.5)),
    ("table2.ita", lambda: costmodel.energy_comparison()["ita"]["total_pj"],
     lambda v: v == pytest.approx(4.05, abs=0.05)),
    ("table2.improvement", lambda: costmodel.energy_comparison()
     ["improvement_vs_int8"]["x"], lambda v: v == pytest.approx(49.6, abs=0.5)),
    ("table2.ita_dram", lambda: costmodel.energy_comparison()["ita"]
     ["dram_pj"], lambda v: v == 0.0),
    ("power.device_w", lambda: costmodel.system_power(20.0, 7e9)["device_w"],
     lambda v: 1.0 <= v <= 1.3),
    ("power.system_lo", lambda: costmodel.system_power(20.0, 7e9)
     ["system_w_lo"], lambda v: 6.0 <= v <= 8.0),
    ("power.system_hi", lambda: costmodel.system_power(20.0, 7e9)
     ["system_w_hi"], lambda v: 11.0 <= v <= 13.0),
    ("table4.raw_1.1b", lambda: costmodel.die_area_mm2(1.1e9)["raw_mm2"],
     lambda v: v == pytest.approx(528, abs=1)),
    ("table4.overheads_1.1b", lambda: costmodel.die_area_mm2(1.1e9)
     ["with_overheads_mm2"], lambda v: v == pytest.approx(850, abs=2)),
    ("table4.final_1.1b", lambda: costmodel.die_area_mm2(1.1e9)["final_mm2"],
     lambda v: v == pytest.approx(520, abs=2)),
    ("table4.raw_7b", lambda: costmodel.die_area_mm2(7e9)["raw_mm2"],
     lambda v: v == pytest.approx(3360, abs=2)),
    ("table4.overheads_7b", lambda: costmodel.die_area_mm2(7e9)
     ["with_overheads_mm2"], lambda v: v == pytest.approx(5410, abs=5)),
    ("table4.conservative_7b", lambda: costmodel.die_area_mm2(
        7e9, conservative=True)["final_mm2"],
     lambda v: v == pytest.approx(7885, rel=0.15)),
    ("table4.config_1.1b", lambda: costmodel.unit_cost(1.1e9)["config"],
     lambda v: v == "monolithic"),
    ("table4.silicon_1.1b", lambda: costmodel.unit_cost(1.1e9)
     ["silicon_cost"], lambda v: v == pytest.approx(52, abs=2)),
    ("table4.unit_1.1b", lambda: costmodel.unit_cost(1.1e9)["unit_cost"],
     lambda v: 60 <= v <= 77),
    ("table4.chiplets_7b", lambda: costmodel.unit_cost(7e9)["n_chiplets"],
     lambda v: v == 8),
    ("table4.unit_7b", lambda: costmodel.unit_cost(7e9)["unit_cost"],
     lambda v: 250 <= v <= 420),
    ("table5.nre", lambda: costmodel.unit_cost(1.1e9, volume=10_000)
     ["nre_per_unit"], lambda v: v == pytest.approx(250, abs=1)),
    ("table5.with_nre", lambda: costmodel.unit_cost(1.1e9, volume=10_000)
     ["unit_cost_with_nre"], lambda v: v == pytest.approx(314, abs=10)),
    ("table5.nre_1m", lambda: costmodel.unit_cost(1.1e9, volume=1_000_000)
     ["nre_per_unit"], lambda v: v == pytest.approx(2.5, abs=0.1)),
    ("fig3.software", lambda: costmodel.extraction_barrier()
     ["software_dump_usd"], lambda v: v <= 2_000),
    ("fig3.physical", lambda: costmodel.extraction_barrier()
     ["ita_physical_re_usd"], lambda v: v >= 50_000),
    ("fig3.barrier", lambda: costmodel.extraction_barrier()
     ["barrier_increase_x"], lambda v: v >= 25),
    ("table7.lut_reduction", lambda: fpga.single_neuron_table()
     ["lut_reduction_x"], lambda v: v == pytest.approx(1.81, abs=0.03)),
    ("table7.hardwired_luts", lambda: fpga.single_neuron_table()
     ["hardwired_luts"], lambda v: v == pytest.approx(788, abs=10)),
    ("table7.reg_reduction", lambda: fpga.single_neuron_table()
     ["reg_reduction_x"], lambda v: v == pytest.approx(20.8, abs=0.2)),
    ("table6.n_macs", lambda: fpga.full_network_table()["n_macs"],
     lambda v: v == 16384),
    ("table6.over_capacity", lambda: fpga.full_network_table()
     ["hardwired_over_capacity_x"], lambda v: v == pytest.approx(3.2, abs=0.1)),
    ("table6.fits", lambda: (fpga.full_network_table()["fits_baseline"],
                             fpga.full_network_table()["fits_hardwired"]),
     lambda v: v == (True, False)),
    ("fpga_vs_asic", lambda: fpga.fpga_vs_asic_gap(),
     lambda v: v["asic_gate_reduction_x"] > v["fpga_lut_reduction_x"]),
    ("eq10.bytes_per_token", lambda: splitbrain.TrafficModel.llama2_7b()
     .bytes_per_token(), lambda v: v == pytest.approx(832 * 1024, rel=0.01)),
    ("eq11.bandwidth", lambda: splitbrain.TrafficModel.llama2_7b()
     .bandwidth_bytes_per_s(20), lambda v: v == pytest.approx(16.64e6,
                                                             rel=0.05)),
    ("csd.example_7", lambda: (csd.csd_nonzero_digits(7),
                               csd.binary_nonzero_digits(7),
                               dict((sh, s) for s, sh in csd.csd_encode(7))),
     lambda v: v == (2, 3, {3: 1, 0: -1})),
    ("csd.plan_adders", lambda: [csd.shift_add_plan(w).num_adders
                                 for w in (0, 4, 7, 5)],
     lambda v: v == [0, 0, 1, 1]),
    ("csd.adder_reduction_int8", lambda: csd.adder_reduction(
        np.random.default_rng(0).integers(-127, 128, 200_000), num_bits=8)
     ["adder_reduction_frac"], lambda v: 0.30 <= v <= 0.45),
    ("csd.reconstructs_non_adjacent",
     lambda: all(_naf(n) for n in range(-(2 ** 12), 2 ** 12)),
     lambda v: v is True),
    ("eq7-9.bytes_per_layer", lambda: (
        splitbrain.TrafficModel.llama2_7b()
        .device_to_host_kv_bytes_per_layer(),
        splitbrain.TrafficModel.llama2_7b()
        .host_to_device_attn_bytes_per_layer(),
        splitbrain.TrafficModel.llama2_7b().logits_bytes()),
     lambda v: v == (16 * 1024, 8 * 1024, 64_000)),
    ("table3.interfaces", lambda: {
        r["interface"]: (r["total_ms"], r["tokens_per_s"])
        for r in splitbrain.TrafficModel.llama2_7b().interface_table()},
     lambda v: (v["PCIe 3.0 x4"][0] == pytest.approx(5.3, abs=0.1)
                and v["PCIe 3.0 x4"][1] == pytest.approx(188, abs=3)
                and v["Thunderbolt 4"][0] == pytest.approx(5.2, abs=0.1)
                and v["USB 3.0"][0] == pytest.approx(7.9, abs=0.1)
                and v["USB 3.0"][1] == pytest.approx(126, abs=3)
                and v["USB 4.0"][0] == pytest.approx(5.5, abs=0.1))),
    ("cpu_scenario", lambda: splitbrain.TrafficModel.llama2_7b()
     .interface_latency(splitbrain.INTERFACES["pcie3x4"],
                        host_attention_s=splitbrain.HOST_ATTENTION_CPU_S)
     ["tokens_per_s"], lambda v: 10 <= v <= 20),
]


@pytest.mark.parametrize("name,value,check", PAPER, ids=[p[0] for p in PAPER])
def test_paper_numbers(name, value, check):
    v = value()
    assert check(v), (name, v)
