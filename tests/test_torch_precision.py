"""ops/precision.full_f32: the pin of full-f32 contractions, nested (a
simulation's chunk around each function's own pin) and on an exception."""

import pytest
import torch

from cuda_iblb_11_tpu_torch.ops.precision import full_f32

PINNED = ("highest", "ieee", "ieee", False)


def _precision():
    b = torch.backends
    return (torch.get_float32_matmul_precision(),
            b.cuda.matmul.fp32_precision, b.mkldnn.matmul.fp32_precision,
            b.cudnn.allow_tf32)


@pytest.fixture
def caller_high():
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        yield _precision()
    finally:
        torch.set_float32_matmul_precision(saved)


def test_nested_pins_restore_once(caller_high):
    assert caller_high == ("high", "tf32", "tf32", True)

    @full_f32()
    def inner():
        return _precision()

    with full_f32():
        assert _precision() == PINNED
        assert inner() == PINNED
        assert _precision() == PINNED   # the inner exit left the pin
        with full_f32():
            assert inner() == PINNED
        assert _precision() == PINNED
    assert _precision() == caller_high
    assert inner() == PINNED
    assert _precision() == caller_high


def test_exception_restores_the_caller(caller_high):
    @full_f32()
    def fails():
        assert _precision() == PINNED
        raise KeyError("inside")

    with pytest.raises(KeyError):
        with full_f32():
            fails()
    assert _precision() == caller_high
    assert full_f32._depth == 0
