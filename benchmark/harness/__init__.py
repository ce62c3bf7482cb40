"""The benchmark's harness: registry, traffic, driver, spans and trace."""
