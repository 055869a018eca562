"""Configurations of the port: the paper's lear-msn1 forest (``lear_msn1``)."""
