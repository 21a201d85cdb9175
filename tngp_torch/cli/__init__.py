"""Command-line entry points of the port (`python -m tngp_torch.cli.main_nerf`)."""
