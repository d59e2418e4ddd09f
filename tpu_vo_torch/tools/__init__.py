"""Tools that run the port on the card (stage_bench, patch_slots_probe,
device_time, select_ablation, phase_ablation, fast_ablation,
run_benchmarks), and reference_band, which computes the OpenCV
reference's trajectories and bands on the CPU."""
