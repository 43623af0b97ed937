"""Text outputs of a run: the .thrm records and the .traj frames."""
