"""env subpackage."""
