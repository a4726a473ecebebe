"""The operation and byte counts against hand counts at small shapes."""
import pytest

from port_bench.harness import counts

TINY = {"rgb": True, "conv_hidden": 2, "deconv_hidden": 3, "degrees": 1,
        "rep_copies": 2, "group_reparam_in_dims": 10}


def test_conv_layers_by_hand():
    layers = counts.conv_layers(TINY)
    # encoder: 3->2 at 32x32, 2->4 at 16x16, 4->8 at 8x8, 8->16 at 4x4,
    # 16->10 k4 s1 p0 at 1x1; decoder: 8->3 (1->4), 3->3 (4->8, 8->16,
    # 16->32), 3->3 (32->64): 2 cin cout 16 and the output (conv) or input
    # (transpose conv) pixels
    want = [2 * 3 * 2 * 16 * 1024, 2 * 2 * 4 * 16 * 256,
            2 * 4 * 8 * 16 * 64, 2 * 8 * 16 * 16 * 16, 2 * 16 * 10 * 16,
            2 * 8 * 3 * 16 * 1, 2 * 3 * 3 * 16 * 16, 2 * 3 * 3 * 16 * 64,
            2 * 3 * 3 * 16 * 256, 2 * 3 * 3 * 16 * 1024]
    assert [l["flops"] for l in layers] == want
    assert [l["input_grad"] for l in layers] == [False] + [True] * 9
    assert counts.forward_flops(TINY) == sum(want) + 2 * 10 * 9
    # training: forward, weight gradient, input gradient but the images'
    assert counts.train_conv_flops(TINY, False) == 3 * sum(want) - want[0]
    enc = sum(want[:5])
    assert counts.train_conv_flops(TINY, True) == \
        3 * sum(want) - want[0] + 3 * enc - want[0]


def test_flagship_forward():
    flagship = {"rgb": True, "conv_hidden": 50, "deconv_hidden": 200,
                "degrees": 6, "rep_copies": 10}
    # 3->50 at 32x32, then three convs of 2 * 16 * 50 * 100 * 256 each
    # (50->100 at 16x16, 100->200 at 8x8, 200->400 at 4x4), 400->10 at 1x1
    enc = 2 * 3 * 50 * 16 * 1024 + 3 * 40960000 + 2 * 400 * 10 * 16
    dec = 2 * 490 * 200 * 16 + 2 * 200 * 200 * 16 * (16 + 64 + 256) \
        + 2 * 200 * 3 * 16 * 1024
    assert counts.forward_flops(flagship) == enc + dec + 180


def test_bounds_by_hand():
    # K1 at L = 0, C = 1, one sample, shared spectrum: angles 3 + spectrum
    # 1 + J 1 + out 1 floats; 2*2*1 + 3*3*1 operations
    assert counts.chain_bound(1, 0, 1, True) == pytest.approx(
        max(4 * 6 / counts.HBM_BYTES_PER_S, 13 / counts.FP32_FLOP_PER_S))
    # at L = 6, C = 10, 512 samples the bytes bound: 4 (3B + SC + n_J +
    # 3BSC) with n_J = 7 (4 * 49 - 1) / 3 = 455
    assert counts.chain_res_bound(512, 6, 10, True) == pytest.approx(
        4 * (3 * 512 + 490 + 455 + 3 * 512 * 490) / counts.HBM_BYTES_PER_S)
    # K3 at N = B = 2, k = 0: 4 (6 + 6 + 2) bytes against 2 (30 + 11)
    assert counts.density_bound(2, 2, 0, False) == pytest.approx(
        max(56 / counts.HBM_BYTES_PER_S, 82 / counts.FP32_FLOP_PER_S))
    assert counts.density_bound(2, 2, 0, True) == pytest.approx(
        max(4 * 26 / counts.HBM_BYTES_PER_S, 2 * 77 / counts.FP64_FLOP_PER_S))
