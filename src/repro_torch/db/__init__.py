"""Relational layer of the port: tables, operators, the copied physical
planner and cost model, the resident plan executor and TPC-H."""
