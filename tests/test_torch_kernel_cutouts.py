"""``python -m codd_torch.tools.kernel_cutouts``' copies of the kernels'
sources, checked as text on the CPU (they are built and timed only on a
card): every cut-out of every target applies to the checkout's source and
changes it, and the cut-outs of kernel 5's backward reach both of its
kernels, the f32 form and the bf16-score form."""

import pytest

from codd_torch.ops import kernels
from codd_torch.tools import kernel_cutouts as kc

CASES = [(k, n) for k, (_, cuts, _, _) in kc.TARGETS.items() for n in cuts]


def _source(kernel):
    return (kernels.CSRC / kc.TARGETS[kernel][0]).read_text()


@pytest.mark.parametrize("kernel,name", CASES)
def test_cutout_applies_to_the_checkout(kernel, name):
    src = _source(kernel)
    cut = kc.TARGETS[kernel][1][name](src)
    assert (cut == src) == (name == "as_is")


@pytest.mark.parametrize("name,marker", [
    ("no_sigmoid_u", "? logit : 0.f;"),
    ("no_p", "p1[e] = "),
    ("no_block_sums", "dae[o * AC + 8 * c + j] = __fadd_rn(__fadd_rn(aa"),
])
def test_gn_backward_cutouts_reach_both_forms(name, marker):
    """Each of these cuts the part out of the f32 kernel and out of the
    bf16-score kernel: the stand-in appears twice."""
    cut = kc.GN_BACKWARD_CUTOUTS[name](_source("gn_backward"))
    assert cut.count(marker) == 2


def test_gn_backward_key_cutout_takes_the_prepass():
    """Where the bf16 form has its key pre-pass, ``no_key_splits`` drops the
    pass's launch and the f32 kernel's key splits."""
    src = _source("gn_backward")
    cut = kc.GN_BACKWARD_CUTOUTS["no_key_splits"](src)
    launch = "gn_backward_bf16_keys_kernel<<<"
    assert launch in src and launch not in cut
    assert "split_key(kf0[s], h0, l0);" in cut


def test_tile_warp_no_sort_keeps_the_planes():
    """Without the sort, the bf16 form's row pass still finds each pixel's
    plane where the sort would have left it."""
    cut = kc.TILE_WARP_CUTOUTS["bwd_no_sort"](_source("tile_warp"))
    assert "plane[W + x] = (unsigned)col0;" in cut
    assert "__match_any_sync(" not in cut
