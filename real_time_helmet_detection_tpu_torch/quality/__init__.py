"""The quality matrix of the port: held-out mAP of the quality levers and
of the latency tiers at trained weights, and the calibration of the
cascade's escalation threshold and the streams' tile-skip threshold
(ref scripts/quality_matrix.py:1-84). `fixture` builds the data,
`sweeps` holds the threshold sweeps and their selection rules, `cost`
the counting model and the served latency of a tier's b1 predict, and
`matrix` is the command line:

    python -m real_time_helmet_detection_tpu_torch.quality.matrix --tiers
"""
