"""Pipeline parallelism (port of ``repro.parallel``'s pipeline and inner
engine; the GSPMD sharding rules are ROADMAP A.11b)."""
