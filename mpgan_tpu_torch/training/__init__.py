"""Run configuration and sampling."""
