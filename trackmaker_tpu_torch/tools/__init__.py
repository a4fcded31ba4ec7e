"""Measurement tools of the port (counterparts of ``bench.py``'s window
probe and of ``tools/exp_xcorr_streams.py``, ``tools/prof_fused.py``,
``tools/exp_attempt_tiles.py`` and ``tools/exp_offset_add.py``).

Each runs on the card as ``python -m trackmaker_tpu_torch.tools.<name>``;
importing one runs nothing.

    health             the window health probe: round trip, launch floor, stream rate
    exp_xcorr_streams  the two-stream correlation experiment against kernel #1
    prof_fused         the flagship stage profiler, with the attempt-only stage
    exp_attempt_tiles  the attempt kernel's per-candidate product skeletons, timed
    exp_offset_add     three epilogues of one product, each checked against its oracle
"""
