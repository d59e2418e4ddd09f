"""Tools that run the port on the card (stage_bench, patch_slots_probe,
device_time, select_ablation, phase_ablation, fast_ablation)."""
