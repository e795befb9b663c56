"""The fp32 FMA-peak kernel K7's plain version and tool against the JAX
package's tools/vpu_peak.py, and what can be checked of the kernel without
a card.

The JAX ``_build(n_acc, 32)(b)`` runs its Pallas kernel in interpret mode
(once per module, in a fixture). ``peak_plain`` with the JAX grid (64
programs of (8, 128) lanes) computes the same chains; XLA on the CPU may
contract y*y + b into one FMA and torch does not, so the two agree within
rtol 1e-5, not bitwise. The cases take b where the sums depend on the
step count and the start values (the tool's -0.75, and 0.25, the map's
neutral fixed point): at the JAX tool's 0.01 every chain reaches its
fixed point within ~8 steps and any number of steps gives the same sums.
"""
import ctypes
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import vpu_peak as jax_vpu_peak

from fourd_ray_tracing_tpu_torch.ops.cuda import build
from fourd_ray_tracing_tpu_torch.ops.cuda import vpu_peak as k7
from fourd_ray_tracing_tpu_torch.tools import vpu_peak as tool

ROUNDS = 32
CASES = [(n_acc, b) for n_acc in (8, 16) for b in (tool.B, 0.25)]


@pytest.fixture(scope="module")
def jax_reference():
    return {(n, b): float(jax_vpu_peak._build(n, ROUNDS)(jnp.float32(b))) for n, b in CASES}


@pytest.mark.parametrize("n_acc,b", CASES)
def test_plain_matches_jax_kernel(n_acc, b, jax_reference):
    sums = k7.peak_plain(n_acc, ROUNDS, b)
    assert sums.shape == (jax_vpu_peak.GRID,) and sums.dtype == torch.float32
    np.testing.assert_allclose(float(sums.double().sum()), jax_reference[(n_acc, b)], rtol=1e-5)


@pytest.mark.parametrize("n_acc,b", CASES)
def test_plain_sums_depend_on_steps_and_starts(n_acc, b):
    """The check above is not vacuous: half the steps move the sums by far
    more than its tolerance, and chains that start apart stay apart."""
    sums = float(k7.peak_plain(n_acc, ROUNDS, b).double().sum())
    half = float(k7.peak_plain(n_acc, ROUNDS // 2, b).double().sum())
    assert abs(half - sums) > 100 * 1e-5 * abs(sums)
    y = k7.chains(n_acc, ROUNDS, b, programs=1, rows=1)[:, 0, 0]  # (n_acc, 128)
    first_acc, last_acc = float(y[0].sum()), float(y[-1].sum())
    first_lane, last_lane = float(y[:, 0].sum()), float(y[:, -1].sum())
    assert abs(first_acc - last_acc) > 1e-5 * abs(first_acc)
    assert abs(first_lane - last_lane) > 1e-5 * abs(first_lane)


def test_block_sum_plain_is_the_fused_chains_in_the_kernels_order():
    """block_sum_plain: one rounding a step (within a few ulps of two
    roundings at 64 steps), summed as a 256-thread block sums."""
    fused = float(k7.chains(16, 64, tool.B, 1, k7.ROWS_PER_BLOCK, fused=True).double().sum())
    twice = float(k7.peak_plain(16, 64, tool.B, programs=1, rows=k7.ROWS_PER_BLOCK)[0])
    block = k7.block_sum_plain(16, 64, tool.B)
    assert block.dim() == 0 and block.dtype == torch.float32
    np.testing.assert_allclose(float(block), fused, rtol=1e-6)
    np.testing.assert_allclose(fused, twice, rtol=1e-5)
    assert float(k7.block_sum_plain(16, 32, tool.B)) != float(block)


def test_rate_above_the_cards_peak_raises():
    tool.check_below_peak(66_900.0, 66_908.16, "at the peak")
    with pytest.raises(RuntimeError, match="skipped steps"):
        tool.check_below_peak(133_000.0, 66_908.16, "half the trips")


def test_plain_is_per_block_what_the_kernel_computes():
    """A 256-thread block holds 2 rows of 128 lanes: its sum is the sum of
    those rows of the JAX layout, which restarts its lanes every 128
    threads."""
    rows8 = k7.peak_plain(16, ROUNDS, 0.01, programs=2, rows=8)
    rows2 = k7.peak_plain(16, ROUNDS, 0.01, programs=8, rows=2)
    np.testing.assert_allclose(rows2.double().sum().item(), rows8.double().sum().item(),
                               rtol=1e-6)
    assert torch.equal(rows2[0], rows2[1])  # lanes repeat: every block computes the same


def test_flops_count_two_per_fma():
    assert k7.flops(8, 32, 64 * 8 * 128) == 2.0 * 8 * 128 * 8 * 32 * 64
    assert tool.default_rounds(48) % k7.UNROLL == 0
    assert all(n * tool.default_rounds(n) <= tool.STEPS_PER_THREAD for n in k7.N_ACCS)


def test_cpu_route_prints_lines_and_payload(capsys):
    assert tool.main(["--device", "cpu", "--rounds", "16"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [line["n_acc"] for line in lines[:-1]] == list(k7.N_ACCS)
    assert all(line["device"] == "cpu" and line["gflops"] > 0 for line in lines[:-1])
    payload = lines[-1]
    assert {"metric", "value", "unit", "device", "n_acc", "note"} <= set(payload)
    assert payload["metric"] == "fp32_fma_peak_gflops" and payload["unit"] == "GFLOP/s"
    assert payload["device"] == "cpu" and payload["value"] == max(x["gflops"] for x in lines[:-1])


def test_card_route_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the card route runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--rounds", "16"])


def test_entry_point_and_signature_declared():
    """From the source text, without a build: the C entry point, its
    ctypes signature in build.SIGNATURES, and each step one __fmaf_rn (the
    build's -fmad=false would split y*y + b into FMUL + FADD)."""
    src = (build.CSRC_DIR / "vpu_peak.cu").read_text()
    assert re.search(r'extern "C" int fourd_peak_launch\(int n_acc, float b, int trips, '
                     r'int blocks, float\* block_sums,\s+void\* stream\)', src)
    assert "__fmaf_rn(y[k], y[k], b)" in src
    for n_acc in k7.N_ACCS:
        assert f"case {n_acc}: fourd_peak_kernel<{n_acc}>" in src
    argtypes, restype = build.SIGNATURES["fourd_peak_launch"]
    assert argtypes == [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_void_p] and restype is ctypes.c_int


def test_launch_refuses_cpu_tensors_and_bad_arguments():
    with pytest.raises(ValueError, match="CUDA"):
        k7.launch_peak(8, 16, 0.01, torch.empty(4))
    with pytest.raises(ValueError, match="n_acc"):
        k7.peak_plain(12, 16, 0.01)
    with pytest.raises(ValueError, match="multiple of 16"):
        k7.peak_plain(8, 20, 0.01)


SASS = """
        Function : _Z17fourd_peak_kernelILi8EEvfiPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   FADD R2, R2, R3 ;
        /*0020*/                   FFMA R4, R4, R4, R0 ;
        /*0030*/                   FFMA R5, R5, R5, R0 ;
        /*0040*/                   IADD3 R6, R6, 0x1, RZ ;
        /*0050*/               @P0 BRA 0x20 ;
        /*0060*/                   FMUL R7, R7, R7 ;
        /*0070*/                   EXIT ;
        Function : _Z17fourd_peak_kernelILi16EEvfiPf
        /*0000*/                   FFMA R4, R4, R4, R0 ;
        /*0010*/                   BRA 0x0 ;
"""


def test_sass_loop_counts_read_the_loop_body():
    funcs = k7.parse_sass(SASS)
    assert set(funcs) == {"_Z17fourd_peak_kernelILi8EEvfiPf", "_Z17fourd_peak_kernelILi16EEvfiPf"}
    assert k7.loop_counts(funcs["_Z17fourd_peak_kernelILi8EEvfiPf"]) == {"FFMA": 2, "FMUL": 0,
                                                                         "FADD": 0}
    assert k7.loop_counts(funcs["_Z17fourd_peak_kernelILi16EEvfiPf"])["FFMA"] == 1
    with pytest.raises(RuntimeError, match="no loop"):
        k7.loop_counts(funcs["_Z17fourd_peak_kernelILi8EEvfiPf"][:3])
