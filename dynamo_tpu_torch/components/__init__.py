"""Standalone service components of the port (the metrics aggregator;
the planner is ``dynamo_tpu_torch.planner``)."""
