"""The port's experiment apps (counterparts of the repository's ``apps/``)."""
