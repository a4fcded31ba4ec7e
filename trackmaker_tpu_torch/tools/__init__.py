"""Measurement tools of the port (counterparts of ``bench.py``'s window
probe and of ``tools/exp_xcorr_streams.py``, ``tools/prof_fused.py``,
``tools/exp_attempt_tiles.py``, ``tools/exp_offset_add.py`` and
``tools/multihost_dryrun.py``, and of ``__graft_entry__.py``'s
``dryrun_multichip``).

Each runs on the card as ``python -m trackmaker_tpu_torch.tools.<name>``;
importing one runs nothing.

    health             the window health probe: round trip, launch floor, stream rate
    exp_xcorr_streams  the two-stream correlation experiment against kernel #1
    prof_fused         the flagship stage profiler, with the attempt-only stage
    exp_attempt_tiles  the attempt kernel's per-candidate product skeletons, timed
    exp_offset_add     three epilogues of one product, each checked against its oracle
    multihost_dryrun   one process of the multi-process batch decode over gloo
    dryrun_multichip   the sharded decodes' four checks over a mesh of explicit devices
"""
