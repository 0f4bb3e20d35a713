"""Multi-device training (port of hulc_tpu/parallel)."""
