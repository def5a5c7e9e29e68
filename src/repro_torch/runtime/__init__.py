"""Fault-tolerance runtime: retry, straggler watchdog, heartbeat."""
