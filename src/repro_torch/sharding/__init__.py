"""Multi-device execution of the port (the reference's GSPMD placement,
written as one worker process per mesh device): ``pool`` starts and runs
the workers, and its ``ModelAxis`` is the round's all-gather over a
``"model"`` axis. ``repro_torch.experiments.shard`` drives it for the
sweep."""
