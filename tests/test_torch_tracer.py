"""chip_smoke.py's tracer on the CPU: how a profile's kernels are held
against independent tallies (dropped_kernels), by kernel names as the
profiler gives them on the card, and how its device events are filed
(kernel_group).  The profile itself needs the card (chip_smoke.traced)."""

import pytest

import chip_smoke

GEMM = ("void (anonymous namespace)::sm90::gemm_kernel<float, float, float, 128, 1, 0>"
        "(CUtensorMap, CUtensorMap, CUtensorMap, float const*, float const*, float const*, "
        "float2 const*, float const*, float*, int, int, int, "
        "(anonymous namespace)::sm90::EpiExtra)")
GEMM_BF16 = "void (anonymous namespace)::sm90::gemm_bf16_kernel<256, 0>(CUtensorMap, int)"
SPLIT = "void (anonymous namespace)::sm90::split_weights_kernel<float>(float const*, long long)"
SPLIT_T = "(anonymous namespace)::sm90::split_weights_t_kernel(float const*, int, int)"
ATTN = "void (anonymous namespace)::attention_tc_kernel<32, 1, 24>(float const*, int)"
ATTN_BWD = "void (anonymous namespace)::attention_bwd_tc_kernel<32, 24>(float const*, int)"
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor>"
COPY = "Memcpy HtoD (Pinned -> Device)"


def _events(**counts):
    names = {"gemm": GEMM, "gemm_bf16": GEMM_BF16, "split": SPLIT, "split_t": SPLIT_T,
             "attn": ATTN, "attn_bwd": ATTN_BWD, "torch": ELEMENTWISE, "copy": COPY}
    return {names[k]: (0.5 * n, n) for k, n in counts.items()}


@pytest.mark.parametrize("counted,calls,events,dropped", [
    # a whole profile: every counted kind and every launch call seen
    ({"gemm": 4, "split_weights": 4, "attention_tc": 1}, 12,
     _events(gemm=4, split=4, attn=1, torch=3, copy=2), {}),
    # a kind's name is not another's part: gemm_bf16_kernel is no
    # gemm_kernel, split_weights_t_kernel no split_weights_kernel,
    # attention_bwd_tc_kernel no attention_tc_kernel
    ({"gemm": 2, "split_weights": 1, "attention_tc": 1}, 6,
     _events(gemm_bf16=2, split_t=1, attn_bwd=1, gemm=2, split=1, attn=1), {}),
    ({"gemm": 2, "split_weights": 1, "attention_tc": 1}, 4,
     _events(gemm_bf16=2, split_t=1, attn_bwd=1),
     {"gemm": 2, "split_weights": 1, "attention_tc": 1}),
    # the library counted more than the profile shows
    ({"gemm": 4, "split_weights": 4}, 8, _events(gemm=3, split=4, torch=1),
     {"gemm": 1}),
    # PyTorch's own launches missing: more launch calls than kernels (the
    # copies are no kernels)
    ({"gemm": 1}, 5, _events(gemm=1, torch=2, copy=3), {"launch calls": 2}),
    # a kind the run never launched
    ({"gemm": 0, "ln_bwd": 0}, 0, {}, {}),
])
def test_dropped_kernels_against_the_tallies(counted, calls, events, dropped):
    assert chip_smoke.dropped_kernels(events, counted, calls) == dropped


@pytest.mark.parametrize("name,group", [
    (GEMM, "forward GEMMs (#5, wgmma)"),
    (GEMM.replace("128, 1, 0>", "112, 0, 4>"), "data-gradient GEMMs (#6, wgmma)"),
    (GEMM.replace("128, 1, 0>", "128, 0, 3>"), "data-gradient GEMMs (#6, wgmma)"),
    (GEMM.replace("128, 1, 0>", "112, 0, 6>"), "forward GEMMs (#5, wgmma)"),
    (SPLIT, "weight splits (#5)"),
    (SPLIT_T, "transposed weight splits (#6)"),
])
def test_training_groups_file_the_gemm_by_its_epilogue(name, group):
    assert chip_smoke.kernel_group(name, chip_smoke.TRAIN_GROUPS) == group
