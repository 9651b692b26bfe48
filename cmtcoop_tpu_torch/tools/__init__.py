"""Command-line tools of the port, run as
`python -m cmtcoop_tpu_torch.tools.<name>`."""
