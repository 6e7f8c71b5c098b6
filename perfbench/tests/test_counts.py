"""The work counters against counts worked by hand from the shapes."""
from perfbench import counts

WIDTHS = (32, 43, 57, 76, 101)


def hand_convs(h, w):
    """The 28 convs typed out: (H, W, Cin, Cout)."""
    e = [(1, 10, 32), (1, 64, 32), (1, 32, 32), (2, 32, 43), (2, 86, 43), (2, 43, 43),
         (4, 43, 57), (4, 114, 57), (4, 57, 57), (8, 57, 76), (8, 152, 76), (8, 76, 76),
         (16, 76, 101), (16, 202, 101), (16, 101, 101),
         (32, 101, 101), (32, 202, 101), (32, 101, 101),
         (16, 202, 76), (16, 76, 76), (8, 152, 57), (8, 57, 57), (4, 114, 43), (4, 43, 43),
         (2, 86, 32), (2, 32, 32), (1, 64, 3), (1, 3, 3)]
    return [(h // f, w // f, ci, co) for f, ci, co in e]


def test_conv_list_is_the_network():
    got = [c[1:] for c in counts.rdae_convs(800, 800, WIDTHS)]
    assert sorted(got) == sorted(hand_convs(800, 800))
    assert len(got) == 28


def test_flops_by_hand():
    want = sum(2 * h * w * ci * co * 9 for h, w, ci, co in hand_convs(800, 800))
    assert counts.conv_flops(counts.rdae_convs(800, 800, WIDTHS)) == want
    # the first conv alone: 800 x 800 pixels, 10 in, 32 out, 9 taps, 2 ops
    assert counts.conv_flops([("c", 800, 800, 10, 32)]) == 2 * 640000 * 10 * 32 * 9
    assert round(want / 1e9, 1) == 95.0
    step = 3 * 4 * 7 * counts.conv_flops(counts.rdae_convs(256, 256, WIDTHS))
    assert step == 3 * 28 * sum(2 * h * w * ci * co * 9 for h, w, ci, co in hand_convs(256, 256))


def test_bytes_and_bound_by_hand():
    one = ("c", 100, 50, 8, 16)
    assert counts.conv_bytes([one]) == 2 * (5000 * 8 + 9 * 8 * 16 + 5000 * 16)
    peaks = {"hbm_bytes_per_s": 1e12, "bf16_flops": 1e15}
    convs = counts.rdae_convs(800, 800, WIDTHS)
    want = 0.0
    for h, w, ci, co in hand_convs(800, 800):
        b = 2 * (h * w * ci + 9 * ci * co + h * w * co)
        f = 2 * h * w * ci * co * 9
        want += max(b / 1e12, f / 1e15)
    assert abs(counts.bound_s(convs, peaks) - want) < 1e-15
