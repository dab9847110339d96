"""The paper's IDA pipelines on the device path."""
