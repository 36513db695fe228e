"""The port's card-only measuring tools, as far as the CPU can hold them:
they import without nvcc, triton or a card, refuse to run without CUDA with
exit code 1 and no result, and serve_profile's grouping of kernel names puts
the names a serving forward or a training step shows on an H100 into the
expected families."""

import re
import types

import pytest
import torch

from gfla_tpu_torch.tools import kernel_split, serve_profile

needs_no_card = pytest.mark.skipif(torch.cuda.is_available(),
                                   reason="checks the refusal without CUDA")


@needs_no_card
@pytest.mark.parametrize("tool,argv", [
    (kernel_split, []), (serve_profile, []),
    (serve_profile, ["--model=dance", "--train"])],
    ids=["kernel_split", "serve_profile", "serve_profile-dance"])
def test_tool_refuses_without_cuda(tool, argv, capsys):
    assert tool.main(argv) == 1
    out, err = capsys.readouterr()
    assert out == "" and "CUDA is not available" in err


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::warp_fwd_kernel<4, true, true>(float "
     "const*)", "warp forward kernel"),
    ("void (anonymous namespace)::warp_bwd_pos_kernel<5, true>(float "
     "const*)", "warp backward kernels"),
    ("void (anonymous namespace)::warp_bwd_w1_kernel<3, true>(float "
     "const*)", "warp backward kernels"),
    ("gfla::reduce_parts(float const*, int, unsigned long, float*)",
     "warp backward kernels"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::"
     "native::(anonymous namespace)::TensorListMetadata<4>, at::native::"
     "(anonymous namespace)::FusedAdamMathFunctor<float, 4>>", "optimizer"),
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_"
     "tilesize256x64x8_stage3", "convolutions"),
    ("void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>",
     "transposed convolutions"),
    ("void cudnn::engines_precompiled::nhwcToNchwKernel<float, float>",
     "layout conversions"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, "
     "at::native::WelfordOps<float>>>", "norm reductions"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>>", "elementwise"),
    ("Memcpy HtoD (Pageable -> Device)", "memory copies"),
    ("something_else", "other"),
])
def test_serve_profile_groups_kernel_names(name, want):
    assert serve_profile.family(name) == want


def test_kernel_split_variants_name_a_whole_kernel_first():
    for variants in kernel_split.SOURCES.values():
        assert list(variants)[0] == 0 and variants[0] == "whole kernel"
        assert sorted(variants) == list(range(len(variants)))


@pytest.mark.parametrize("stem", ["warp_fwd", "warp_bwd", "max_corr",
                                  "attn_math_fwd", "attn_math_bwd"])
def test_kernel_split_sources_exist_and_take_split_values(stem):
    """Every source the tool splits is a kernel file whose GFLA_SPLIT
    values, in it and in the headers it includes, are the tool's
    variants."""
    src = (kernel_split.CSRC / f"{stem}.cu").read_text()
    assert "#ifndef GFLA_SPLIT" in src
    text = src + "".join(
        (kernel_split.CSRC / name).read_text()
        for name in re.findall(r'#include "(\w+\.cuh)"', src))
    used = {int(n) for n in re.findall(r"GFLA_SPLIT [!=]= (\d)", text)}
    assert used == set(kernel_split.SOURCES[stem]) - {0}


def test_kernel_split_refuses_unknown_sources():
    with pytest.raises(SystemExit):
        kernel_split.main(["--only", "attn_math_fwd,nonesuch"])


@pytest.mark.parametrize("name,flag,want", [
    ("Optimizer.step#Adam.step", False, True),
    ("aten::convolution", False, True),
    ("my_range", True, True),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::"
     "native::(anonymous namespace)::TensorListMetadata<4>>", False, False),
], ids=["optimizer-range", "op-range", "user-annotation", "adam-kernel"])
def test_serve_profile_skips_annotation_ranges(name, flag, want):
    """Ranges drawn around kernels would count their time twice."""
    evt = types.SimpleNamespace(name=name, is_user_annotation=flag)
    assert serve_profile.is_annotation(evt) == want
