"""The frozen count functions give the bounds the program's kernel table
(PERF.md section 6) lists for the preset's shapes."""

import pytest

from benchmark.harness import counts


def ms(flops):
    return 1e3 * counts.bound(flops, 0)


def test_lstm_bounds_of_the_kernel_table():
    scaler = counts.lstm_flops(256, 2000, 1, 48, 1) + \
        counts.lstm_flops(256, 2000, 48, 48, 1)
    assert ms(scaler) == pytest.approx(0.449, abs=5e-4)
    assert ms(2 * counts.lstm_flops(256, 300, 1, 48, 1)) == \
        pytest.approx(0.047, abs=5e-4)
    assert ms(counts.lstm_flops(256, 300, 96, 64, 1)) == \
        pytest.approx(0.096, abs=5e-4)


def test_stage1_work_of_one_read():
    work = counts.Stage1Work(2000, (48, 48), 6, 1, 300, 48, 64, True)
    frames = 5000
    assert work.ops(frames) == (
        counts.lstm_flops(1, 2000, 1, 48, 1) +
        counts.lstm_flops(1, 2000, 48, 48, 1) +
        frames * counts.viterbi_frame_ops(6, 1) +
        2 * counts.lstm_flops(1, 300, 1, 48, 1) +
        counts.lstm_flops(1, 300, 96, 64, 1))
    # every part is bound by its operations
    assert work.least_seconds(frames) == pytest.approx(
        work.ops(frames) / counts.PEAK_FP32)
    plain = counts.Stage1Work(2000, (48, 48), 6, 1, 300, 48, 64, False)
    assert plain.ops(frames) < work.ops(frames)
