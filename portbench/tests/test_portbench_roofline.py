"""The bound arithmetic on shapes whose answer is known by hand."""

import pytest

from portbench import roofline


def test_distance_block_is_bound_by_operations_at_a_served_batch():
    # 128 queries over 250,000 rows of 768: 2 * 128 * 250000 * 768 FP32
    # operations = 4.9152e10 at 67 TFLOP/s; the bytes take far less
    t = roofline.distance_block_s(128, 250000, 768)
    assert t == pytest.approx(4.9152e10 / 67e12)


def test_distance_block_is_bound_by_bytes_at_one_query():
    nbytes = 250000 * 768 * 4 + 768 * 4 + 250000 * 4 + 250000 * 4
    assert roofline.distance_block_s(1, 250000, 768) == pytest.approx(nbytes / 3.35e12)


def test_bq_scan_reduce_reads_the_codes_once():
    # 24 words a row: 96 bytes; 1,600 candidates of 8 bytes a query
    nbytes = 250000 * 96 + 128 * 96 + 250000 + 128 * 1600 * 8
    ops = 2.0 * 128 * 250000 * 768
    assert roofline.bq_scan_reduce_s(128, 250000, 768, 1600) == pytest.approx(
        max(nbytes / 3.35e12, ops / (8 * 1979e12)))
    assert nbytes / 3.35e12 > ops / (8 * 1979e12)
