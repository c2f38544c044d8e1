"""Evaluation: the evaluator and the numpy metric math (port of ``c2m_tpu/eval``)."""
