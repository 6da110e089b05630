"""The eval step and the serving entry point."""
