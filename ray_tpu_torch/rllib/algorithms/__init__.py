"""algorithms subpackage."""
