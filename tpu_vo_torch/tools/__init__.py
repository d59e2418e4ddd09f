"""Tools that run the port on the card (stage_bench)."""
