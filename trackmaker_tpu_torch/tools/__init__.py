"""Measurement tools of the port (counterparts of ``bench.py``'s window
probe and of ``tools/exp_xcorr_streams.py`` and ``tools/prof_fused.py``).

Each runs on the card as ``python -m trackmaker_tpu_torch.tools.<name>``;
importing one runs nothing.

    health             the window health probe: round trip, launch floor, stream rate
    exp_xcorr_streams  the two-stream correlation experiment against kernel #1
    prof_fused         the flagship stage profiler, with the attempt-only stage
"""
