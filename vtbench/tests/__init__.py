"""Tests of the benchmark harness (CPU, tiny sizes; the card's marked
``cuda``)."""
