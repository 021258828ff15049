"""DataLog: dict-of-lists experiment logger (the port's own copy of
``mjrl_tpu/utils/logger.py``, which is pure Python).

Parity: ``log_kv``, ``save_log`` (log.pickle + log.csv), ``get_current_log``,
``shrink_to`` (resume truncation, logger.py:51-57), ``read_log`` with
iteration-monotonicity validation (logger.py:59-81) — but CSV cells are
parsed with a safe literal parser, not ``eval`` (known reference defect,
SURVEY.md §"do not replicate").
"""

import csv
import os
import pickle


def _parse_cell(x):
    if x == "" or x is None:
        return None
    try:
        return int(x)
    except ValueError:
        pass
    try:
        return float(x)
    except ValueError:
        pass
    if x in ("True", "False"):
        return x == "True"
    return x


class DataLog:
    def __init__(self):
        self.log = {}
        self.max_len = 0

    def log_kv(self, key, value):
        if key not in self.log:
            self.log[key] = []
        self.log[key].append(value)
        if len(self.log[key]) > self.max_len:
            self.max_len = len(self.log[key])

    def save_log(self, save_path):
        os.makedirs(save_path, exist_ok=True)
        with open(os.path.join(save_path, "log.pickle"), "wb") as f:
            pickle.dump(self.log, f)
        with open(os.path.join(save_path, "log.csv"), "w", newline="") as f:
            fieldnames = list(self.log.keys())
            writer = csv.DictWriter(f, fieldnames=fieldnames)
            writer.writeheader()
            for row in range(self.max_len):
                row_dict = {}
                for key in fieldnames:
                    vals = self.log[key]
                    if row < len(vals):
                        row_dict[key] = vals[row]
                writer.writerow(row_dict)

    def get_current_log(self):
        return {key: vals[-1] for key, vals in self.log.items() if vals}

    def shrink_to(self, num_entries):
        for key in self.log:
            self.log[key] = self.log[key][:num_entries]
        self.max_len = num_entries

    def read_log(self, log_path):
        assert log_path.endswith(".csv")
        with open(log_path) as f:
            reader = csv.DictReader(f)
            listr = list(reader)
        data = {}
        for key in reader.fieldnames:
            data[key] = [_parse_cell(row.get(key)) for row in listr
                         if row.get(key) not in ("", None)]
        if "iteration" in data:
            it = data["iteration"]
            assert all(it[i] <= it[i + 1] for i in range(len(it) - 1)), \
                "iteration column must be monotonic"
        self.log = data
        self.max_len = max((len(v) for v in data.values()), default=0)
        return data
