"""The ranking service and its launch-overhead calibration."""
