"""The port held to the benchmark's plain references on the CPU, at
reduced widths: every cell's trainer (the population's vmapped step, the
single trial's ``make_train_step``), each family (the MoE decoder, the
encoder-decoder), through the checked steps: each step's loss, every
parameter's gradient norm at the first step and its change over the
AdamW steps, per trial.

Computing in float32 the port agrees with the reference to float32's
rounding (``tiny.F32_LIMITS``).  The port computing in bf16 and the
reference computing its products in float8 (the benchmark's control)
each fail those limits.
"""
import pytest
import torch

from portbench import compare as C
from portbench import harness, tiny
from portbench import traffic as T

WORKLOADS = ("granite-moe.pop", "whisper.pop", "granite-moe.solo")
SEED = 2 ** 31 + 977


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _numbers(cell, prog_prec=None):
    hp = T.hyperparameters(cell.traffic, SEED)
    if prog_prec is None:
        trainer, prog, _ = harness.checked_steps(cell, SEED, "cpu", hp)
        trainer.close()
    else:
        prog = harness.follow_reference(cell, SEED, "cpu", hp, prog_prec)
    ref = harness.follow_reference(cell, SEED, "cpu", hp)
    return C.gaps(prog, ref, harness.leaf_names(cell))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_port_in_float32_agrees_with_reference(workload):
    got = _numbers(tiny.cell(workload, "float32"))
    assert C.verdict(got, tiny.F32_LIMITS), got


@pytest.mark.parametrize("workload", WORKLOADS)
def test_port_in_bfloat16_fails_the_float32_limit(workload):
    got = _numbers(tiny.cell(workload, "bfloat16"))
    assert not C.verdict(got, tiny.F32_LIMITS), got


@pytest.mark.parametrize("workload", WORKLOADS)
def test_float8_control_fails_the_float32_limit(workload):
    got = _numbers(tiny.cell(workload, "float32"), prog_prec="fp8")
    assert not C.verdict(got, tiny.F32_LIMITS), got


def test_reference_layout_is_the_ports():
    from portbench.program import model_config, shapes
    for workload in WORKLOADS:
        cell = tiny.suite().cell(workload)
        want = shapes(model_config(cell.run_config))
        got = {leaf[0]: tuple(leaf[1])
               for leaf in cell.reference.leaves(cell.run_config)}
        assert got == want, workload


def test_reference_refuses_what_it_does_not_compute():
    cell = tiny.cell("granite-moe.pop")
    run = dict(cell.run_config, n_shared_experts=1)
    with pytest.raises(NotImplementedError):
        cell.reference.leaves(run)
