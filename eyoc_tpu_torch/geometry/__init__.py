"""Rigid transforms, registration metrics and the QCP Kabsch solver."""
