"""The benchmark's harness: finds a cell's pieces by name, drives the
program, measures, traces and compares."""
