"""The marker-delimited results table that the sweep drivers merge into a
markdown file (a copy of ``merge_marker_table`` of the JAX package's
``scripts/_results_table.py``: the same bytes for the same rows)."""
import os


def merge_marker_table(out_path, begin, end, caption, header, descriptions,
                       results, format_row, section_title):
    """Write/refresh a marker-delimited results table in `out_path`.

    descriptions: ordered {config_name: row_label}; results:
    {config_name: result}; format_row(desc, result) -> "| ... |" row.
    Rows for configs absent from `results` are preserved verbatim from
    the existing table (matched by their row label), keeping
    `descriptions` order.
    """
    lines = [caption, "", header,
             "|" + "---|" * (header.count("|") - 1)]
    doc = ""
    if os.path.exists(out_path):
        with open(out_path) as f:
            doc = f.read()

    header_first_col = header.split("|")[1].strip()
    old_rows = {}
    if begin in doc and end in doc:
        for row in doc.split(begin)[1].split(end)[0].splitlines():
            if row.startswith("| ") and not row.startswith(
                    f"| {header_first_col}"):
                old_rows[row.split("|")[1].strip()] = row
    for name, desc in descriptions.items():
        if name in results:
            lines.append(format_row(desc, results[name]))
        elif desc in old_rows:
            lines.append(old_rows[desc])
    block = f"{begin}\n" + "\n".join(lines) + f"\n{end}"

    if begin in doc and end in doc:
        doc = doc.split(begin)[0] + block + doc.split(end, 1)[1]
    elif doc:
        doc = doc.rstrip() + f"\n\n## {section_title}\n\n" + block + "\n"
    else:
        doc = f"# {section_title}\n\n" + block + "\n"
    with open(out_path, "w") as f:
        f.write(doc)
    print(f"wrote {out_path}")
